"""Exact k-nearest neighbours and neighbourhood gathers.

Port of heterofusionrcnn_tpu/ops/grouping.py (`knn_point`, `group_point`).
`knn_point` calls the custom op `hfr::knn`: on CUDA tensors it launches
the kernels of `csrc/knn.cu`, on CPU tensors it runs `knn_point_plain`.
Both use the direct squared distance (q - c)^2 rounded term by term and
order neighbours by (distance, index): the semantics of the TPU kernel and
of its jnp mirror `pallas_knn._knn_reference_jnp`, not the matmul-expanded
distance that the JAX package's CPU path uses.

On the card the kernel has two arms (`knn_arm`, chosen inside the op): a
brute scan for small sets, and for large ones a sorted arm that
Morton-sorts the points and cuts the candidates into tiles with boxes
(`knn_prep`, one kernel), then skips every tile whose box lies farther
than its queries' k-th distances. Both give the plain version's indices
and distances bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from heterofusionrcnn_torch.ops.dispatch import I, P, CudaKernel, one_device, pointers

# One launch count per KNN: the brute kernel or the sorted arm's search.
KNN_KERNEL = CudaKernel(
    "knn.cu",
    {"hfr_knn": [P, P, P, P, I, I, I, I],
     "hfr_knn_sorted": [P, P, P, P, P, P, P, P, P, I, I, I, I]},
    exact=True,
)
# The sorted arm's prep kernel (keys, sort, float4 candidates, tile boxes),
# counted apart.
KNN_PREP_KERNEL = CudaKernel(
    "knn.cu", {"hfr_knn_prep": [P, P, P, P, P, P, P, I, I, I]}, exact=True, name="knn_prep",
)

KNN_TILE = 32              # candidates a tile of the sorted arm (knn.cu's kTile)
KNN_KEY_BITS = 20          # the BEV Morton key: 10 bits of x and z each
KNN_SORT_BITS = 15         # the key's top bits the prep sorts by (knn.cu's note says why)
# The arm threshold, from tools/knn_sweep.py on an H100 over the batch-4
# forward's and the KITTI frames' own calls (PERF.md): from 4096 candidates
# a set the sorted arm wins or ties, at 1024 and below the brute scan wins.
KNN_SORTED_MIN_N = 4096    # candidates a set from which the sorted arm runs
KNN_SORTED_MAX_POINTS = 16384  # the prep kernel's largest set (one block sorts it)

# Elements of one (B, chunk, N) distance table in the plain version.
_PLAIN_CHUNK_ELEMS = 1 << 24


def knn_arm(n: int, p: int) -> str:
    """The arm the card runs for sets of n candidates and p queries:
    "sorted" from KNN_SORTED_MIN_N (4096) candidates on while neither set
    exceeds KNN_SORTED_MAX_POINTS (16384), "brute" otherwise. On the main
    path: the RPN's 16384 x 16384, 1024 x 4096 and 16384 x 4096 (queries x
    candidates) sorted, its other six calls and the RCNN's four brute."""
    sorted_fits = KNN_SORTED_MIN_N <= n and max(n, p) <= KNN_SORTED_MAX_POINTS
    return "sorted" if sorted_fits else "brute"


def knn_point(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor, arm: Optional[str] = None):
    """k nearest candidates of each query.

    Args:
      xyz: (B, N, 3) candidates; new_xyz: (B, P, 3) queries; k <= min(16, N).
        `new_xyz is xyz` (the same object) lets the sorted arm sort once;
        the op takes that choice as its argument `same_set`, so a traced
        graph keeps it.
      arm: None (the main path: `knn_arm` picks it from the shape), or
        "brute" / "sorted" to force one arm on the card (tests and
        measurements). The CPU always runs the plain version.
    Returns:
      dists (B, P, k) ascending squared distances, idx (B, P, k) int32.
    """
    n = xyz.shape[1]
    if not 1 <= k <= min(16, n):
        raise ValueError(f"knn needs 1 <= k <= min(16, N), got k={k} N={n}")
    if arm not in (None, "brute", "sorted"):
        raise ValueError(f"unknown knn arm {arm!r}")
    return torch.ops.hfr.knn(xyz, new_xyz, k, new_xyz is xyz, arm)


@torch.library.custom_op("hfr::knn", mutates_args=(), device_types="cpu")
def _knn_op(xyz: torch.Tensor, new_xyz: torch.Tensor, k: int, same_set: bool,
            arm: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    return knn_point_plain(k, xyz, new_xyz)


@_knn_op.register_kernel("cuda")
def _knn_cuda(xyz: torch.Tensor, new_xyz: torch.Tensor, k: int, same_set: bool,
              arm: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    one_device(xyz, new_xyz)
    if xyz.dtype != torch.float32 or new_xyz.dtype != torch.float32:
        raise ValueError("knn kernel takes float32 points")
    if same_set:
        if new_xyz.shape != xyz.shape:
            raise ValueError(f"same_set with sets of shapes {tuple(xyz.shape)} and "
                             f"{tuple(new_xyz.shape)}")
        new_xyz = xyz
    b, n, _ = xyz.shape
    p = new_xyz.shape[1]
    if (arm or knn_arm(n, p)) == "sorted":
        return knn_sorted(k, xyz, new_xyz)
    xyz = xyz.contiguous()
    new_xyz = new_xyz.contiguous()
    dist, idx = _results(b, p, k, xyz.device)
    KNN_KERNEL.launch(
        "hfr_knn", *pointers(xyz, new_xyz, idx, dist), I(b), I(n), I(p), I(k)
    )
    return dist, idx


@_knn_op.register_fake
def _knn_fake(xyz: torch.Tensor, new_xyz: torch.Tensor, k: int, same_set: bool,
              arm: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    one_device(xyz, new_xyz)
    shape = (new_xyz.shape[0], new_xyz.shape[1], k)
    return new_xyz.new_empty(shape), new_xyz.new_empty(shape, dtype=torch.int32)


def _results(b: int, p: int, k: int, device: torch.device):
    """Empty (B, P, k) float32 distances and int32 indices (an op's
    outputs may not share storage)."""
    return (torch.empty((b, p, k), dtype=torch.float32, device=device),
            torch.empty((b, p, k), dtype=torch.int32, device=device))


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


class KnnTiles(NamedTuple):
    """The sorted arm's prepared points.

    cand: (B, N, 4) float32, the candidates in key order, (x, y, z, original
      index as int32 bits); boxes: (B, ceil(N / KNN_TILE), 2, 4) float32,
      each tile's (lo, hi) corner (fourth component 0); skeys: (B, N) int32
      sorted candidate sort keys (`knn_sort_keys`). For another query set,
      qperm: (B, P) int32 the queries in key order, sqkeys: (B, P) int32
      their sorted sort keys (None for the same set, whose queries are
      `cand`).
    """

    cand: torch.Tensor
    boxes: torch.Tensor
    skeys: torch.Tensor
    qperm: Optional[torch.Tensor]
    sqkeys: Optional[torch.Tensor]


def knn_prep(xyz: torch.Tensor, new_xyz: torch.Tensor) -> KnnTiles:
    """Keys, stable sort, float4 candidates and tile boxes of the sorted
    arm on CUDA tensors: one launch of the prep kernel (its plain version
    is `knn_prep_plain`). `new_xyz is xyz` (the same object) is the same
    set: the queries are the sorted candidates."""
    b, n, _ = xyz.shape
    p = new_xyz.shape[1]
    if one_device(xyz, new_xyz).type != "cuda":
        raise ValueError("knn_prep launches the prep kernel: it takes CUDA tensors")
    if max(n, p) > KNN_SORTED_MAX_POINTS:
        raise ValueError(f"knn prep sorts sets of up to {KNN_SORTED_MAX_POINTS} points, "
                         f"got N={n} P={p}")
    same_set = new_xyz is xyz
    xyz = xyz.contiguous()
    ntiles = -(-n // KNN_TILE)
    words = [b * n * 4, b * ntiles * 8, b * n] + ([] if same_set else [b * p, b * p])
    parts = torch.empty(sum(words), dtype=torch.int32, device=xyz.device).split(words)
    cand = parts[0].view(torch.float32).view(b, n, 4)
    boxes = parts[1].view(torch.float32).view(b, ntiles, 2, 4)
    skeys = parts[2].view(b, n)
    qrs = qperm = sqkeys = None
    if not same_set:
        qrs = new_xyz.contiguous()
        qperm, sqkeys = parts[3].view(b, p), parts[4].view(b, p)
    KNN_PREP_KERNEL.launch("hfr_knn_prep", *pointers(xyz, qrs, cand, boxes, skeys, qperm, sqkeys),
                           I(b), I(n), I(p))
    return KnnTiles(cand, boxes, skeys, qperm, sqkeys)


def _part1by1(v: torch.Tensor) -> torch.Tensor:
    v = v & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    return (v | (v << 1)) & 0x55555555


def morton_keys(points: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """(B, M, 3) points -> (B, M) int32 BEV Morton keys over (x, z) on the
    grid of the (B, N, 3) set `frame`: 1024 steps per axis from its minimum
    to its maximum, clipped (`_morton_key_bev` when points is frame)."""
    lo = frame.amin(dim=1, keepdim=True)
    ext = frame.amax(dim=1, keepdim=True) - lo
    # A true division (a Python number over a tensor multiplies by the
    # reciprocal, which rounds differently from the kernel and JAX).
    scale = torch.full_like(ext, 1023.0) / torch.clamp(ext, min=1e-6)
    g = torch.clamp((points - lo) * scale, 0.0, 1023.0).to(torch.int32)
    return _part1by1(g[..., 0]) | (_part1by1(g[..., 2]) << 1)


def knn_sort_keys(points: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """The top KNN_SORT_BITS bits of `morton_keys`, which the prep sorts by."""
    return morton_keys(points, frame) >> (KNN_KEY_BITS - KNN_SORT_BITS)


def knn_prep_plain(xyz: torch.Tensor, new_xyz: torch.Tensor) -> KnnTiles:
    """Plain PyTorch version of `knn_prep`, bit for bit."""
    b, n, _ = xyz.shape
    skeys, perm = torch.sort(knn_sort_keys(xyz, xyz), dim=1, stable=True)
    pts = torch.gather(xyz, 1, perm[..., None].expand(b, n, 3))
    bits = perm.to(torch.int32).view(torch.float32)[..., None]
    cand = torch.cat([pts, bits], dim=-1)
    ntiles = -(-n // KNN_TILE)
    pad = ntiles * KNN_TILE - n
    lo = torch.nn.functional.pad(pts, (0, 0, 0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(pts, (0, 0, 0, pad), value=float("-inf"))
    zero = torch.zeros((b, ntiles, 1), dtype=xyz.dtype, device=xyz.device)
    boxes = torch.stack([
        torch.cat([lo.reshape(b, ntiles, KNN_TILE, 3).amin(dim=2), zero], -1),
        torch.cat([hi.reshape(b, ntiles, KNN_TILE, 3).amax(dim=2), zero], -1),
    ], dim=2)
    if new_xyz is xyz:
        return KnnTiles(cand, boxes, skeys, None, None)
    sqkeys, qperm = torch.sort(knn_sort_keys(new_xyz, xyz), dim=1, stable=True)
    return KnnTiles(cand, boxes, skeys, qperm.to(torch.int32), sqkeys)


def knn_sorted(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
               visited: Optional[torch.Tensor] = None):
    """The sorted arm on CUDA tensors: `knn_prep`, then one launch of the
    search kernel; `new_xyz is xyz` is the same set. `visited`: None, or a
    CUDA int64 tensor of one element that gains the (query, candidate)
    pairs the search evaluated."""
    b, n, _ = xyz.shape
    p = new_xyz.shape[1]
    if visited is not None and (visited.dtype != torch.int64 or visited.numel() != 1):
        raise ValueError("visited must be one int64")
    t = knn_prep(xyz, new_xyz)
    qrs = None if new_xyz is xyz else new_xyz.contiguous()
    dist, idx = _results(b, p, k, xyz.device)
    KNN_KERNEL.launch(
        "hfr_knn_sorted",
        *pointers(t.cand, t.boxes, t.skeys, qrs, t.qperm, t.sqkeys, idx, dist, visited),
        I(b), I(n), I(p), I(k),
    )
    return dist, idx


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, P, S) indices -> (B, P, S, C), in points' dtype
    (bf16 features are gathered unchanged, exactly as JAX's gather)."""
    b, n, c = points.shape
    _, p, s = idx.shape
    rows = (
        torch.arange(b, device=idx.device)[:, None] * n + idx.reshape(b, p * s).long()
    ).reshape(-1)
    return points.reshape(b * n, c)[rows].reshape(b, p, s, c)
