"""box_3d <-> anchor conversions (PyTorch port of
heterofusionrcnn_tpu/core/box_3d_encoder.py).

anchor format: [x, y, z, dim_x, dim_y, dim_z], axis-aligned extents in the
camera frame. box_3d -> anchor projects the (possibly rotated) box onto the
axes; with `ortho_rotate` the rotation first snaps to the nearest multiple
of 90 degrees (`torch.round`, half to even as `jnp.round`), otherwise the
dims are the rotated box's bounding extents.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def box_3d_to_anchor(boxes_3d: torch.Tensor, ortho_rotate: bool = False) -> torch.Tensor:
    """(..., 7) box_3d -> (..., 6) anchor."""
    x, y, z, l, w, h, ry = (boxes_3d[..., i] for i in range(7))
    if ortho_rotate:
        half_pi = math.pi / 2
        ry = torch.round(ry / half_pi) * half_pi
    cos_ry = torch.abs(torch.cos(ry))
    sin_ry = torch.abs(torch.sin(ry))
    dim_x = l * cos_ry + w * sin_ry
    dim_z = w * cos_ry + l * sin_ry
    return torch.stack([x, y, z, dim_x, h, dim_z], dim=-1)


def anchor_to_box_3d(anchors: torch.Tensor) -> torch.Tensor:
    """(..., 6) anchor -> (..., 7) box_3d with ry = 0: l = dim_x, w = dim_z,
    h = dim_y."""
    x, y, z, dx, dy, dz = (anchors[..., i] for i in range(6))
    return torch.stack([x, y, z, dx, dz, dy, torch.zeros_like(x)], dim=-1)


def np_box_3d_to_anchor(boxes_3d: np.ndarray, ortho_rotate: bool = False) -> np.ndarray:
    """Host twin: numpy in, float32 numpy out (the JAX twin computes in
    float32 too)."""
    boxes = torch.from_numpy(np.asarray(boxes_3d, np.float32))
    return box_3d_to_anchor(boxes, ortho_rotate).numpy()
