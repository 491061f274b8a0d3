"""PointNet++ in float32 plain PyTorch: a set-abstraction (SA) pyramid
and a mirrored feature-propagation (FP) decoder, with the port's module
and parameter names (`models/extractors/pointnet.py`).

SA level: FPS downsample -> ball query (or KNN) grouping -> local
coordinates -> shared MLP -> max over the neighbours. FP level:
inverse-distance three-NN interpolation of the coarse features, the skip
features concatenated, a shared MLP.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hfbench.reference.config import PointNetConfig
from hfbench.reference.layers import BatchNorm, DenseBN, dropout
from hfbench.reference.ops import (
    farthest_point_sample,
    gather_point,
    group_point,
    knn_point,
    query_ball_point,
    three_interpolate,
    three_nn,
)


class SharedMLP(nn.Module):
    """Per-point (per-neighbour) MLP: Dense (no bias) -> ReLU -> BatchNorm
    (momentum 0.99, epsilon 1e-3 in flax's terms) for each width."""

    def __init__(self, in_channels: int, features: Sequence[int]):
        super().__init__()
        self.depth = len(features)
        for i, f in enumerate(features):
            self.add_module(f"mlp{i}", nn.Linear(in_channels, f, bias=False))
            self.add_module(f"bn{i}", BatchNorm(f))
            in_channels = f

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"bn{i}")(F.relu(getattr(self, f"mlp{i}")(x)))
        return x


def _grouped(xyz, features, new_xyz, idx):
    """Neighbour coordinates relative to their centre, with the neighbours'
    features concatenated: (B, P, S, 3 + C)."""
    grouped = group_point(xyz, idx) - new_xyz[:, :, None, :]
    if features is None:
        return grouped
    return torch.cat([grouped, group_point(features, idx)], dim=-1)


class SAModule(nn.Module):
    """Set abstraction."""

    def __init__(self, in_channels: int, npoint: int, radius: float, nsample: int,
                 mlp: Sequence[int], use_knn: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample, self.use_knn = npoint, radius, nsample, use_knn
        self.mlp = SharedMLP(3 + in_channels, mlp)
        self.out_channels = mlp[-1]

    def forward(self, xyz, features):
        """xyz (B, N, 3), features (B, N, C) or None -> new_xyz (B, npoint, 3),
        new features (B, npoint, mlp[-1])."""
        new_xyz = gather_point(xyz, farthest_point_sample(xyz, self.npoint))
        if self.use_knn:
            _, idx = knn_point(self.nsample, xyz, new_xyz)
        else:
            idx, _ = query_ball_point(self.radius, self.nsample, xyz, new_xyz)
        out = self.mlp(_grouped(xyz, features, new_xyz, idx))
        return new_xyz, out.amax(dim=2)


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction : one branch a
    (radius, nsample, mlp) over the same FPS centres, concatenated."""

    def __init__(self, in_channels: int, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]]):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, list(radii), list(nsamples)
        for i, mlp in enumerate(mlps):
            self.add_module(f"mlp{i}", SharedMLP(3 + in_channels, mlp))
        self.out_channels = sum(m[-1] for m in mlps)

    def forward(self, xyz, features):
        new_xyz = gather_point(xyz, farthest_point_sample(xyz, self.npoint))
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            idx, _ = query_ball_point(radius, nsample, xyz, new_xyz)
            outs.append(getattr(self, f"mlp{i}")(_grouped(xyz, features, new_xyz, idx)).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class FPModule(nn.Module):
    """Feature propagation."""

    def __init__(self, in_channels: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp)
        self.out_channels = mlp[-1]

    def forward(self, xyz1, xyz2, features1, features2):
        """features2 (B, N2, C2) at the coarse xyz2 (B, N2, 3) propagated onto
        the dense xyz1 (B, N1, 3), the skip features1 (B, N1, C1) or None
        concatenated -> (B, N1, mlp[-1])."""
        dist, idx = three_nn(xyz1, xyz2)
        inv = 1.0 / dist.clamp(min=1e-10)
        out = three_interpolate(features2, idx, inv / inv.sum(-1, keepdim=True))
        if features1 is not None:
            out = torch.cat([out, features1], dim=-1)
        return self.mlp(out)


class PointNet(nn.Module):
    """The mirrored SA / FP stack.

    forward(points (B, N, 3), features (B, N, Cf) or None) ->
    (points of the output level, per-point features (B, N_out, C_out))."""

    def __init__(self, config: PointNetConfig, in_channels: int):
        super().__init__()
        self.config = config
        chans: List[int] = [in_channels]
        for i, sa in enumerate(config.sa_modules):
            if sa.use_msg:
                m = SAModuleMSG(chans[-1], sa.npoint, sa.radii, sa.nsamples, sa.mlps)
            else:
                m = SAModule(chans[-1], sa.npoint, sa.radius, sa.nsample, sa.mlp, sa.use_knn)
            self.add_module(f"sa{i}", m)
            chans.append(m.out_channels)
        c = chans[-1]
        n_levels = len(config.sa_modules)
        for i, fp in enumerate(config.fp_modules):
            level = n_levels - 1 - i
            self.add_module(f"fp{i}", FPModule(c + chans[level], fp.mlp))
            c = fp.mlp[-1]
        for i, fc in enumerate(config.fc_layers):
            self.add_module(f"fc{i}", DenseBN(c, fc.C))
            c = fc.C
        self.out_channels = c

    def forward(self, points: torch.Tensor, features: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """`generator`: the dropout draws of the fc layers in training."""
        cfg = self.config
        xyzs, ftss = [points], [features]
        for i in range(len(cfg.sa_modules)):
            xyz, fts = getattr(self, f"sa{i}")(xyzs[-1], ftss[-1])
            xyzs.append(xyz)
            ftss.append(fts)
        fts = ftss[-1]
        n_levels = len(cfg.sa_modules)
        for i in range(len(cfg.fp_modules)):
            level = n_levels - 1 - i  # propagate onto this level's points
            fts = getattr(self, f"fp{i}")(xyzs[level], xyzs[level + 1], ftss[level], fts)
        for i, fc in enumerate(cfg.fc_layers):
            fts = getattr(self, f"fc{i}")(fts)
            if self.training:
                fts = dropout(fts, fc.dropout_rate, generator)
        return xyzs[n_levels - len(cfg.fp_modules)], fts
