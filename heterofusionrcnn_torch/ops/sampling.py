"""Farthest point sampling, point gathers and the random samplers.

Port of heterofusionrcnn_tpu/ops/sampling.py (`farthest_point_sample`,
`gather_point`, `inverse_density_sampling`, `prob_sample`).
`farthest_point_sample` calls the custom op
`hfr::farthest_point_sample`: on CUDA tensors it launches the kernel of
`csrc/fps.cu` (each set on a thread-block cluster whose size `fps_plan`
picks on the card it runs on), on CPU tensors it runs
`farthest_point_sample_plain`.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from heterofusionrcnn_torch.ops.dispatch import (
    I,
    P,
    CudaKernel,
    cluster_plan,
    cluster_threads,
    pointers,
    sm_count,
)
from heterofusionrcnn_torch.ops.grouping import knn_point

FPS_KERNEL = CudaKernel(
    "fps.cu", {"hfr_fps": [P, P, I, I, I, I, I], "hfr_fps_clusters": [I, I, I]}, exact=True
)
# Points a CTA takes before a set is spread over a larger cluster, and
# points a thread (tools/cluster_sweep.py on an H100: at 2-8 points a
# thread a CTA's barrier and reductions cost less than at 1).
FPS_POINTS_PER_CTA = 1024
FPS_POINTS_PER_THREAD = 4


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative max-min FPS: (B, N, 3) float32 -> (B, npoint) int32 indices.
    Slot 0 is point 0; each next slot is the point farthest (squared
    distance) from the picked set, the lowest index on ties."""
    return torch.ops.hfr.farthest_point_sample(xyz, npoint)


@torch.library.custom_op("hfr::farthest_point_sample", mutates_args=(), device_types="cpu")
def _fps_op(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    return farthest_point_sample_plain(xyz, npoint)


@_fps_op.register_kernel("cuda")
def _fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    return _fps_kernel(xyz, npoint)


@_fps_op.register_fake
def _fps_fake(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)


def fps_plan(b: int, n: int, sms: int, fits) -> Tuple[int, int]:
    """(cluster size, threads a CTA) of the kernel for b sets of n points on
    a card of `sms` SMs; `fits(c, threads)` is the kernel's occupancy query."""
    return cluster_plan(b, n, sms, FPS_POINTS_PER_CTA, FPS_POINTS_PER_THREAD, fits)


@functools.lru_cache(maxsize=None)
def _launch_plan(b: int, n: int, device: torch.device) -> Tuple[int, int]:
    """`fps_plan` on `device` with the kernel's occupancy query, once per shape."""
    return fps_plan(b, n, sm_count(device), lambda c, t: fps_clusters(n, c, t) > 0)


@functools.lru_cache(maxsize=None)
def fps_clusters(n: int, cluster: int, threads: int) -> int:
    """Clusters of the kernel's launch for sets of n points that fit on the
    card at once (0: none)."""
    fit = FPS_KERNEL.load().hfr_fps_clusters(n, cluster, threads)
    if fit < 0:
        raise RuntimeError(f"fps: occupancy query failed ({-fit}) at N={n} cluster={cluster}")
    return fit


def _fps_kernel(xyz: torch.Tensor, npoint: int, cluster: Optional[int] = None,
                threads: Optional[int] = None) -> torch.Tensor:
    """One launch of the kernel, each set on a cluster of `cluster` CTAs of
    `threads` threads (default: `fps_plan`'s choice; for a given cluster,
    FPS_POINTS_PER_THREAD points a thread)."""
    b, n, _ = xyz.shape
    if xyz.dtype != torch.float32 or n > 32768 or npoint < 1:
        raise ValueError(f"fps kernel takes float32 with N <= 32768 and npoint >= 1, "
                         f"got {xyz.dtype} N={n} npoint={npoint}")
    if cluster is None:
        cluster, threads = _launch_plan(b, n, xyz.device)
    threads = threads or cluster_threads(n, cluster, FPS_POINTS_PER_THREAD)
    xyz = xyz.contiguous()
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    FPS_KERNEL.launch("hfr_fps", *pointers(xyz, out), I(b), I(n), I(npoint), I(cluster),
                      I(threads))
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


def inverse_density_sampling(points: torch.Tensor, k: int, sample_num: int,
                             generator: Optional[torch.Generator] = None,
                             uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-density sampling without replacement (JAX
    `inverse_density_sampling`): each point's log share of the mean squared
    distance to its k nearest neighbours (a same-set KNN: the kernel on the
    card) plus Gumbel noise, the top `sample_num`. The noise comes from
    (B, N) uniforms in [0, 1): `uniforms` if given (a test feeds JAX's
    `jax.random.uniform` draws), else drawn from `generator`.

    Args:
      points: (B, N, 3) float32.
    Returns:
      (B, sample_num) int32 indices, by descending key, ties to the lower
      index (`jax.lax.top_k`'s order).
    """
    d, _ = knn_point(k, points, points)  # (B, N, k) ascending squared distances
    avg = d.mean(-1).abs() + 1e-8
    logp = torch.log(avg / avg.sum(-1, keepdim=True))
    if uniforms is None:
        if generator is None:
            raise ValueError("inverse density sampling needs a generator or its uniforms")
        uniforms = torch.rand(logp.shape, generator=generator, device=points.device)
    elif uniforms.shape != logp.shape:
        raise ValueError(f"uniforms of shape {tuple(uniforms.shape)} for points {tuple(points.shape)}")
    gumbel = -torch.log(-torch.log(uniforms + 1e-20) + 1e-20)
    order = torch.sort(logp + gumbel, dim=-1, descending=True, stable=True).indices
    return order[:, :sample_num].to(torch.int32)


def prob_sample(cdf: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF multinomial sampling (JAX `prob_sample`): for each
    uniform of (B, M) the first index of its row of the inclusive CDF
    (B, N) whose value is not below it -> (B, M) int32."""
    return torch.searchsorted(cdf.contiguous(), uniforms.contiguous(), side="left").to(torch.int32)


def gather_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M) indices -> (B, M, C)."""
    b, n, c = points.shape
    rows = (torch.arange(b, device=idx.device)[:, None] * n + idx.long()).reshape(-1)
    return points.reshape(b * n, c)[rows].reshape(b, idx.shape[1], c)
