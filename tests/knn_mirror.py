"""A torch mirror of the sorted KNN arm's search (`knn_sorted_kernel` in
heterofusionrcnn_torch/ops/csrc/knn.cu), for the CPU tests and the card
tests alike (torch only).

It follows the kernel's schedule warp by warp, all warps at once: the
query box of each warp of 32 sorted queries, the centre tile at the
warp's curve position, tiles visited outward in groups of 32 whose bounds
are tested from the warp's query box against the kth at the group's
start (the ballot), each kept tile tested again per query (its own point
against the tile's box and its own k-th distance of the moment; scanned if
any active query passes), and the warp's kth (the max over its active
queries of their k-th distance) after every scanned tile. A scanned tile
joins each query's top-k by (distance, index), which is what the kernel's
inserts give whatever their order. Bounds and distances round in float32
in the kernel's term order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from heterofusionrcnn_torch.ops.grouping import KNN_TILE, knn_prep_plain

NO_INDEX = 2**31 - 1  # the kernel's empty slot: after every candidate


def box_bound(qlo, qhi, clo, chi):
    """knn.cu's `box_bound`: gap per axis max(clo - qhi, qlo - chi, 0), then
    (gx*gx + gy*gy) + gz*gz, over the last dimension (x, y, z)."""
    g = torch.clamp(torch.maximum(clo - qhi, qlo - chi), min=0.0)
    sq = g * g
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def sq_dist(q, c):
    """knn.cu's `sq_dist` of (..., 3) points broadcast against each other."""
    d = q - c
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def zigzag(j, center, ntiles: int):
    """knn.cu's `zigzag`: the j-th tile from `center` outward."""
    left, right = center, ntiles - 1 - center
    off = (j + 1) // 2
    zig = torch.where(j % 2 == 1, center + off, center - off)
    tail = torch.where(right > left, center + (j - left), center - (j - right))
    return torch.where(j <= 2 * torch.minimum(left, right), zig, tail)


def sorted_schedule(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """The sorted arm on CPU tensors (`new_xyz is xyz`: the same set).
    Returns dist (B, P, k) float32, idx (B, P, k) int32 in the queries' own
    order, and the (query, candidate) pairs the kernel evaluates (its
    `visited` count)."""
    same_set = new_xyz is xyz
    t = knn_prep_plain(xyz, new_xyz)
    b, n, _ = xyz.shape
    p = new_xyz.shape[1]
    tile = KNN_TILE
    qw = 32
    nw = -(-p // qw)
    ntiles = -(-n // tile)
    inf = float("inf")

    cpts = t.cand[..., :3]
    cidx = t.cand.view(torch.int32)[..., 3].long()
    if same_set:
        qrow, qpts = cidx, cpts
    else:
        qrow = t.qperm.long()
        qpts = torch.gather(new_xyz, 1, qrow[..., None].expand(b, p, 3))
    qpts = F.pad(qpts, (0, 0, 0, nw * qw - p)).reshape(b, nw, qw, 3)
    active = (torch.arange(nw * qw) < p).reshape(1, nw, qw).expand(b, nw, qw)
    qlo = torch.where(active[..., None], qpts, inf).amin(dim=2)
    qhi = torch.where(active[..., None], qpts, -inf).amax(dim=2)
    nq = active[0].sum(-1)
    mid = torch.arange(nw) * qw + nq // 2
    if same_set:
        center = (mid // tile).expand(b, nw)
    else:
        center = torch.searchsorted(t.skeys, t.sqkeys[:, mid].contiguous(), side="left") // tile
    center = torch.clamp(center, max=ntiles - 1)

    pad = ntiles * tile - n
    cp = F.pad(cpts, (0, 0, 0, pad)).reshape(b, ntiles, tile, 3)
    ci = F.pad(cidx, (0, pad), value=NO_INDEX).reshape(b, ntiles, tile)
    cvalid = (torch.arange(ntiles * tile) < n).reshape(ntiles, tile)
    cnt = cvalid.sum(-1)
    bsel = torch.arange(b)[:, None]

    bd = torch.full((b, nw, qw, k), inf)
    bi = torch.full((b, nw, qw, k), NO_INDEX, dtype=torch.long)
    kth = torch.full((b, nw), inf)
    visited = 0
    for g0 in range(0, ntiles, 32):
        j = torch.arange(g0, min(g0 + 32, ntiles))
        tg = zigzag(j[None, None, :], center[..., None], ntiles)
        bx = t.boxes[torch.arange(b)[:, None, None], tg]
        lb = box_bound(qlo[:, :, None], qhi[:, :, None], bx[..., 0, :3], bx[..., 1, :3])
        ballot = lb <= kth[..., None]
        for lane in range(j.numel()):
            tt = tg[..., lane]
            box = t.boxes[bsel, tt][:, :, None]
            own = box_bound(qpts, qpts, box[..., 0, :3], box[..., 1, :3]) <= bd[..., k - 1]
            go = ballot[..., lane] & (own & active).any(-1)
            if not bool(go.any()):
                continue
            keep = (go[..., None] & cvalid[tt])[:, :, None, :]
            d = torch.where(keep, sq_dist(qpts[:, :, :, None, :], cp[bsel, tt][:, :, None]), inf)
            ix = torch.where(keep, ci[bsel, tt][:, :, None, :], NO_INDEX)
            dd, ii = torch.cat([bd, d], -1), torch.cat([bi, ix.expand_as(d)], -1)
            o = torch.argsort(ii, dim=-1, stable=True)
            dd, ii = dd.gather(-1, o), ii.gather(-1, o)
            o = torch.argsort(dd, dim=-1, stable=True)[..., :k]
            bd, bi = dd.gather(-1, o), ii.gather(-1, o)
            visited += int((go * nq * cnt[tt]).sum())
            kth = torch.where(active, bd[..., k - 1], 0.0).amax(-1)

    rows = qrow[..., None].expand(b, p, k)
    dist = torch.empty((b, p, k)).scatter_(1, rows, bd.reshape(b, nw * qw, k)[:, :p])
    idx = torch.empty((b, p, k), dtype=torch.long).scatter_(1, rows, bi.reshape(b, nw * qw, k)[:, :p])
    return dist, idx.to(torch.int32), visited


def cloud(kind: str, seed: int, b: int, n: int) -> np.ndarray:
    """(b, n, 3) float32 points of one of the shapes the KNN tests use."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":  # inference.random_batch's volume
        x = rng.uniform(-40, 40, (b, n, 3))
        x[..., 2] = np.abs(x[..., 2]) + 1.0
    elif kind == "flat":  # a KITTI scan: wide in x and z, thin in y
        x = np.stack([rng.uniform(-35, 35, (b, n)), rng.uniform(-1, 2.5, (b, n)),
                      rng.uniform(0, 70, (b, n))], -1)
    elif kind == "grid":  # integer coordinates: exact distances, many ties
        x = rng.integers(-6, 7, (b, n, 3))
    elif kind == "dup":  # a block of points repeated
        x = rng.uniform(-20, 20, (b, n, 3))
        x[:, n // 2:n // 2 + n // 8] = x[:, :n // 8]
    elif kind == "same":  # every point identical: extents 0
        x = np.broadcast_to(rng.uniform(-5, 5, (b, 1, 3)), (b, n, 3))
    elif kind == "huge":  # squares overflow: most distances are inf
        x = rng.uniform(-1e20, 1e20, (b, n, 3))
    elif kind == "line":  # collinear, integer steps: ties along the line
        t = rng.integers(-50, 50, (b, n, 1))
        x = t * np.array([0.5, 0.25, -1.0]) + np.array([3.0, -1.0, 2.0])
    else:
        raise ValueError(kind)
    return np.ascontiguousarray(x, dtype=np.float32)
