"""Exact k-nearest neighbours, the ball query and neighbourhood gathers.

Port of heterofusionrcnn_tpu/ops/grouping.py (`knn_point`, `group_point`,
`pairwise_sqdist`, `query_ball_point`, `sort_neighbor_indices`).
`knn_point` with k <= 16 calls the custom op `hfr::knn`: on CUDA tensors
it launches the kernels of `csrc/knn.cu`, on CPU tensors it runs
`knn_point_plain`. Both use the direct squared distance (q - c)^2 rounded
term by term and order neighbours by (distance, index): the semantics of
the TPU kernel and of its jnp mirror `pallas_knn._knn_reference_jnp`, not
the matmul-expanded distance that the JAX package's CPU path uses. With
k > 16 `knn_point` takes the JAX package's own split (`_knn_point_impl`:
the Pallas kernel only for k <= 16): the k smallest of the expanded
distance table, in plain PyTorch on every device.

The ball query and the expanded distance table run in plain PyTorch, as
their JAX counterparts run in plain XLA. The table's cross term is summed
from three elementwise products, so no TF32 matmul ever touches it.

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
# Largest k of the kernel (JAX `_knn_point_impl`: the Pallas kernel for
# k <= 16, the expanded-distance top-k beyond).
KNN_KERNEL_MAX_K = 16
# Elements of one (B, chunk, N) table of the expanded-distance ops (the JAX
# package tiles the query axis by 1024 through `lax.map`).
_TABLE_CHUNK_ELEMS = 1 << 26


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
      xyz: (B, N, 3) candidates; new_xyz: (B, P, 3) queries; 1 <= k <= N.
        k <= 16 runs the kernel's op; k > 16 `knn_point_expanded`, as the
        JAX package does on every backend.
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
    if not 1 <= k <= n:
        raise ValueError(f"knn needs 1 <= k <= N, got k={k} N={n}")
    if arm not in (None, "brute", "sorted"):
        raise ValueError(f"unknown knn arm {arm!r}")
    if k > KNN_KERNEL_MAX_K:
        if arm is not None:
            raise ValueError(f"knn arm {arm!r} with k={k}: the kernel takes k <= {KNN_KERNEL_MAX_K}")
        return knn_point_expanded(k, xyz, new_xyz)
    return torch.ops.hfr.knn(xyz, new_xyz, k, new_xyz is xyz, arm)


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) x (..., N, 3) -> (..., P, N) squared distances in the
    matmul-expanded form |a|^2 - 2 a.b + |b|^2, clamped at 0 (JAX
    `pairwise_sqdist`), float32. The cross term is summed from three
    elementwise products in float32, never a (TF32) matmul."""
    aa = (a * a).sum(-1, keepdim=True)
    bb = (b * b).sum(-1, keepdim=True).transpose(-1, -2)
    at, bt = a.unsqueeze(-2), b.unsqueeze(-3)
    cross = (at[..., 0] * bt[..., 0] + at[..., 1] * bt[..., 1]) + at[..., 2] * bt[..., 2]
    # + 0.0 turns a -0.0 into +0.0, so the bits order as the values.
    return (aa - 2.0 * cross + bb).clamp(min=0.0) + 0.0


def smallest_k(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row of the non-negative float32 table d,
    ascending, the lower index first on ties (`jax.lax.top_k(-d, k)`'s
    order): (values, int32 indices). One int64 top-k over the keys
    (bits of d, index), which are unique."""
    n = d.shape[-1]
    key = (d.view(torch.int32).long() << 32) | torch.arange(n, device=d.device)
    top = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    idx = (top & 0xFFFFFFFF).to(torch.int32)
    return (top >> 32).to(torch.int32).view(torch.float32), idx


def _query_chunks(b: int, p: int, n: int) -> int:
    """Queries a chunk of a (B, chunk, N) table of the expanded-distance ops."""
    return max(1, min(p, _TABLE_CHUNK_ELEMS // max(b * n, 1)))


def knn_point_expanded(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """The k nearest candidates by the expanded distance (JAX
    `_knn_point_impl` off the kernel: `pairwise_sqdist`, then top-k), in
    query chunks: dists (B, P, k) ascending, idx (B, P, k) int32."""
    b, n, _ = xyz.shape
    out = [smallest_k(pairwise_sqdist(q, xyz), k)
           for q in new_xyz.split(_query_chunks(b, new_xyz.shape[1], n), dim=1)]
    return torch.cat([d for d, _ in out], dim=1), torch.cat([i for _, i in out], dim=1)


def _first_k_true(mask: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first k True entries of each row of `mask` (..., N),
    in index order, and the count of True entries capped at k. Slots past
    the count repeat the first hit; an all-False row gives 0s. Returns
    (idx (..., k) int32, cnt (...) int32)."""
    n = mask.shape[-1]
    ar = torch.arange(n, dtype=torch.int32, device=mask.device)
    key = torch.where(mask, ar, torch.full_like(ar, n))
    idx = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    cnt = mask.sum(-1).clamp(max=k).to(torch.int32)
    slot = torch.arange(k, dtype=torch.int32, device=mask.device)
    idx = torch.where(slot < cnt[..., None], idx, idx[..., :1])
    return torch.where(idx >= n, torch.zeros_like(idx), idx), cnt


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """Fixed-radius neighbourhoods (JAX `query_ball_point`): for each query
    of new_xyz (B, P, 3), the first `nsample` points of xyz (B, N, 3) in
    index order whose expanded squared distance is below radius^2,
    underfull balls padded with the first hit, empty ones all 0. In query
    chunks that bound the (B, chunk, N) table (the same result at any
    chunk). Returns idx (B, P, nsample) int32, pts_cnt (B, P) int32."""
    r2 = radius * radius
    b, n, _ = xyz.shape
    out = [_first_k_true(pairwise_sqdist(q, xyz) < r2, nsample)
           for q in new_xyz.split(_query_chunks(b, new_xyz.shape[1], n), dim=1)]
    return torch.cat([i for i, _ in out], dim=1), torch.cat([c for _, c in out], dim=1)


def sort_neighbor_indices(points: torch.Tensor, idx: torch.Tensor,
                          sorting_method: str) -> torch.Tensor:
    """Each neighbourhood's indices reordered for the sorted XConv (JAX
    `sort_neighbor_indices`): "l2" by descending distance from the
    neighbourhood's centroid, or "c<permutation of xyz>" by descending
    lexicographic key of the min-max normalised coordinates (scales 100^i,
    the first neighbour's key pinned to 0). Ties keep the lower slot first
    (`jax.lax.top_k`'s order). points (B, N, 3), idx (B, P, K) -> (B, P, K)."""
    nn_pts = group_point(points, idx)  # (B, P, K, 3)
    if sorting_method.startswith("c"):
        perm = sorting_method[1:]
        if "".join(sorted(perm)) != "xyz":
            raise ValueError(f"unknown sorting method {sorting_method}")
        mn = nn_pts.amin(dim=2, keepdim=True)
        mx = nn_pts.amax(dim=2, keepdim=True)
        normed = (nn_pts - mn) / (mx - mn + 1e-8)
        scaling = torch.tensor([100.0 ** (3 - perm.find(c)) for c in "xyz"],
                               dtype=nn_pts.dtype, device=nn_pts.device)
        key = (normed * scaling).sum(-1)
        key = torch.cat([torch.zeros_like(key[..., :1]), key[..., 1:]], dim=-1)
    elif sorting_method == "l2":
        center = nn_pts.mean(dim=2, keepdim=True)
        key = torch.linalg.vector_norm(nn_pts - center, dim=-1)
    else:
        raise ValueError(f"unknown sorting method {sorting_method}")
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    return torch.gather(idx, -1, order)


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
