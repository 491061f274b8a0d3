"""Farthest point sampling and point gathers.

Port of heterofusionrcnn_tpu/ops/sampling.py (`farthest_point_sample`,
`gather_point`). `farthest_point_sample` launches the CUDA kernel of
`csrc/fps.cu` on CUDA tensors and runs `farthest_point_sample_plain` on
CPU tensors.
"""

from __future__ import annotations

import torch

from heterofusionrcnn_torch.ops.dispatch import I, P, CudaKernel, pointers, use_kernel

FPS_KERNEL = CudaKernel("fps.cu", {"hfr_fps": [P, P, I, I, I]}, exact=True)


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative max-min FPS: (B, N, 3) float32 -> (B, npoint) int32 indices.
    Slot 0 is point 0; each next slot is the point farthest (squared
    distance) from the picked set, the lowest index on ties."""
    b, n, _ = xyz.shape
    if not use_kernel(xyz):
        return farthest_point_sample_plain(xyz, npoint)
    if xyz.dtype != torch.float32 or n > 32768:
        raise ValueError(f"fps kernel takes float32 with N <= 32768, got {xyz.dtype} N={n}")
    xyz = xyz.contiguous()
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    FPS_KERNEL.launch("hfr_fps", *pointers(xyz, out), I(b), I(n), I(npoint))
    return out


def farthest_point_sample_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch FPS with the kernel's arithmetic: squared distances
    rounded term by term, argmax ties to the lowest index."""
    b, n, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    dists = torch.full((b, n), float("inf"), dtype=xyz.dtype, device=xyz.device)
    ar = torch.arange(n, device=xyz.device).expand(b, n)
    last = torch.zeros((b, 1), dtype=torch.long, device=xyz.device)
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    for i in range(npoint):
        out[:, i] = last[:, 0]
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        dists = torch.minimum(dists, (dx * dx + dy * dy) + dz * dz)
        best = dists.amax(dim=1, keepdim=True)
        last = torch.where(dists == best, ar, n).amin(dim=1, keepdim=True)
    return out


def gather_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M) indices -> (B, M, C)."""
    b, n, c = points.shape
    rows = (torch.arange(b, device=idx.device)[:, None] * n + idx.long()).reshape(-1)
    return points.reshape(b * n, c)[rows].reshape(b, idx.shape[1], c)
