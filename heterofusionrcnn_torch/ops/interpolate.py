"""Three-nearest-neighbour feature interpolation (PyTorch port of
heterofusionrcnn_tpu/ops/interpolate.py), PointNet++'s feature
propagation.

Plain PyTorch on every device, as the JAX package computes these in plain
XLA: `three_nn` is the 3 smallest of the expanded distance table
(`grouping.pairwise_sqdist`, in query chunks that bound the table: the RPN's
last level would otherwise hold a (B, 16384, 4096) table), and
`three_interpolate` an inverse-distance weighted gather.
"""

from __future__ import annotations

import torch

from heterofusionrcnn_torch.ops.grouping import group_point, knn_point_expanded


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The 3 nearest known points (B, M, 3) of every unknown point (B, N, 3):
    dist (B, N, 3) ascending squared distances, idx (B, N, 3) int32, ties
    to the lower index (JAX `three_nn`)."""
    return knn_point_expanded(3, known, unknown)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Features (B, M, C) at the known points, weighted over each unknown
    point's three neighbours idx (B, N, 3) by weight (B, N, 3) -> (B, N, C)."""
    return (group_point(points, idx) * weight[..., None]).sum(dim=2)


def three_interpolate_inverse_distance(unknown: torch.Tensor, known: torch.Tensor,
                                       features: torch.Tensor) -> torch.Tensor:
    """`three_nn`, weights w_i = (1 / d_i) / sum_j (1 / d_j) with
    d = max(d, 1e-10), then `three_interpolate` (the FP module's recipe)."""
    dist, idx = three_nn(unknown, known)
    inv = 1.0 / dist.clamp(min=1e-10)
    return three_interpolate(features, idx, inv / inv.sum(-1, keepdim=True))
