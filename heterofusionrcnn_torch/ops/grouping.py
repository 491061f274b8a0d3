"""Exact k-nearest neighbours and neighbourhood gathers.

Port of heterofusionrcnn_tpu/ops/grouping.py (`knn_point`, `group_point`).
`knn_point` launches the CUDA kernel of `csrc/knn.cu` on CUDA tensors and
runs `knn_point_plain` on CPU tensors. Both use the direct squared distance
(q - c)^2 rounded term by term and order neighbours by (distance, index):
the semantics of the TPU kernel and of its jnp mirror
`pallas_knn._knn_reference_jnp`, not the matmul-expanded distance that the
JAX package's CPU path uses.
"""

from __future__ import annotations

import torch

from heterofusionrcnn_torch.ops.dispatch import I, P, CudaKernel, pointers, use_kernel

KNN_KERNEL = CudaKernel("knn.cu", {"hfr_knn": [P, P, P, P, I, I, I, I]}, exact=True)

# Elements of one (B, chunk, N) distance table in the plain version.
_PLAIN_CHUNK_ELEMS = 1 << 24


def knn_point(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """k nearest candidates of each query.

    Args:
      xyz: (B, N, 3) candidates; new_xyz: (B, P, 3) queries; k <= min(16, N).
    Returns:
      dists (B, P, k) ascending squared distances, idx (B, P, k) int32.
    """
    b, n, _ = xyz.shape
    p = new_xyz.shape[1]
    if not 1 <= k <= min(16, n):
        raise ValueError(f"knn needs 1 <= k <= min(16, N), got k={k} N={n}")
    if not use_kernel(xyz, new_xyz):
        return knn_point_plain(k, xyz, new_xyz)
    if xyz.dtype != torch.float32 or new_xyz.dtype != torch.float32:
        raise ValueError("knn kernel takes float32 points")
    xyz = xyz.contiguous()
    new_xyz = new_xyz.contiguous()
    idx = torch.empty((b, p, k), dtype=torch.int32, device=xyz.device)
    dist = torch.empty((b, p, k), dtype=torch.float32, device=xyz.device)
    KNN_KERNEL.launch(
        "hfr_knn", *pointers(xyz, new_xyz, idx, dist), I(b), I(n), I(p), I(k)
    )
    return dist, idx


def knn_point_plain(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """Plain PyTorch KNN with the kernel's arithmetic and order, in query
    chunks that bound the distance table."""
    b, n, _ = xyz.shape
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (b * n))
    dists, idxs = [], []
    for q in new_xyz.split(chunk, dim=1):
        diff = q[:, :, None, :] - xyz[:, None, :, :]
        sq = diff * diff
        d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        sd, si = torch.sort(d, dim=-1, stable=True)
        dists.append(sd[..., :k])
        idxs.append(si[..., :k].to(torch.int32))
    return torch.cat(dists, dim=1), torch.cat(idxs, dim=1)


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, P, S) indices -> (B, P, S, C)."""
    b, n, c = points.shape
    _, p, s = idx.shape
    rows = (
        torch.arange(b, device=idx.device)[:, None] * n + idx.reshape(b, p * s).long()
    ).reshape(-1)
    return points.reshape(b * n, c)[rows].reshape(b, p, s, c)
