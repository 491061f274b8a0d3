"""The point, box and image operations of the reference, in plain PyTorch.

Each function computes what the port's kernel of the same name computes,
with the arithmetic and the tie rules of that kernel's plain version
(`heterofusionrcnn_torch/ops/*.py`, the `*_plain` functions): squared
distances rounded term by term, argmax and top-k ties to the lower index,
greedy NMS in score order. Nothing here launches a kernel of the port.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hfbench.reference.geometry import boxes_3d_to_bev, points_in_box_3d
from hfbench.reference.rotated_iou import _EPS, bev_corners_soa, edges_in_poly_integral

# Elements of one (B, chunk, N) distance table of the KNN.
_PLAIN_CHUNK_ELEMS = 1 << 24
# Elements of one (B, chunk, N) table of the expanded-distance ops.
_TABLE_CHUNK_ELEMS = 1 << 26
# The largest k of the port's KNN kernel; beyond it the expanded distance.
KNN_KERNEL_MAX_K = 16


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, P, S) indices -> (B, P, S, C)."""
    b, n, c = points.shape
    _, p, s = idx.shape
    rows = (torch.arange(b, device=idx.device)[:, None] * n + idx.reshape(b, p * s).long()).reshape(-1)
    return points.reshape(b * n, c)[rows].reshape(b, p, s, c)


def gather_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M) indices -> (B, M, C)."""
    b, n, c = points.shape
    rows = (torch.arange(b, device=idx.device)[:, None] * n + idx.long()).reshape(-1)
    return points.reshape(b * n, c)[rows].reshape(b, idx.shape[1], c)


def knn_point(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """k nearest candidates of each query: squared distances
    (dx^2 + dy^2) + dz^2, a stable sort (ties to the lower index), in query
    chunks; k > 16 by the expanded distance, as the port does on every
    device. Returns dists (B, P, k) ascending, idx (B, P, k) int32."""
    n = xyz.shape[1]
    if not 1 <= k <= n:
        raise ValueError(f"knn needs 1 <= k <= N, got k={k} N={n}")
    if k > KNN_KERNEL_MAX_K:
        return knn_point_expanded(k, xyz, new_xyz)
    b = xyz.shape[0]
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


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) x (..., N, 3) -> (..., P, N) squared distances in the
    expanded form |a|^2 - 2 a.b + |b|^2, clamped at 0, the cross term from
    three elementwise products."""
    aa = (a * a).sum(-1, keepdim=True)
    bb = (b * b).sum(-1, keepdim=True).transpose(-1, -2)
    at, bt = a.unsqueeze(-2), b.unsqueeze(-3)
    cross = (at[..., 0] * bt[..., 0] + at[..., 1] * bt[..., 1]) + at[..., 2] * bt[..., 2]
    return (aa - 2.0 * cross + bb).clamp(min=0.0) + 0.0


def smallest_k(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row of the non-negative table d, ascending,
    ties to the lower index: (values, int32 indices)."""
    n = d.shape[-1]
    key = (d.view(torch.int32).long() << 32) | torch.arange(n, device=d.device)
    top = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    idx = (top & 0xFFFFFFFF).to(torch.int32)
    return (top >> 32).to(torch.int32).view(torch.float32), idx


def _query_chunks(b: int, p: int, n: int) -> int:
    return max(1, min(p, _TABLE_CHUNK_ELEMS // max(b * n, 1)))


def knn_point_expanded(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """The k nearest candidates by the expanded distance, in query chunks."""
    b, n, _ = xyz.shape
    out = [smallest_k(pairwise_sqdist(q, xyz), k)
           for q in new_xyz.split(_query_chunks(b, new_xyz.shape[1], n), dim=1)]
    return torch.cat([d for d, _ in out], dim=1), torch.cat([i for _, i in out], dim=1)


def first_k_true(mask: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first k True entries of each row in index order and
    the count capped at k; slots past the count repeat the first hit, an
    all-False row gives 0s."""
    n = mask.shape[-1]
    ar = torch.arange(n, dtype=torch.int32, device=mask.device)
    key = torch.where(mask, ar, torch.full_like(ar, n))
    idx = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    cnt = mask.sum(-1).clamp(max=k).to(torch.int32)
    slot = torch.arange(k, dtype=torch.int32, device=mask.device)
    idx = torch.where(slot < cnt[..., None], idx, idx[..., :1])
    return torch.where(idx >= n, torch.zeros_like(idx), idx), cnt


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """The first `nsample` points of xyz (index order) within radius of each
    query (expanded squared distance below radius^2), underfull balls
    padded with the first hit: idx (B, P, nsample), pts_cnt (B, P)."""
    r2 = radius * radius
    b, n, _ = xyz.shape
    out = [first_k_true(pairwise_sqdist(q, xyz) < r2, nsample)
           for q in new_xyz.split(_query_chunks(b, new_xyz.shape[1], n), dim=1)]
    return torch.cat([i for i, _ in out], dim=1), torch.cat([c for _, c in out], dim=1)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The 3 nearest known points of every unknown point (expanded distance)."""
    return knn_point_expanded(3, known, unknown)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Features at the known points weighted over each unknown point's three
    neighbours."""
    return (group_point(points, idx) * weight[..., None]).sum(dim=2)


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative max-min FPS: slot 0 is point 0, each next slot the point
    farthest from the picked set, (dx^2 + dy^2) + dz^2, ties to the lowest
    index. (B, N, 3) -> (B, npoint) int32."""
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


def oriented_nms(bev_boxes, scores, iou_thresh, max_keep, valid_mask=None):
    """Greedy rotated-rectangle NMS per frame: at each step the alive box of
    the highest score (lowest index on ties) is kept and every alive box of
    BEV IoU above the threshold with it is suppressed. Returns keep_idx
    (B, max_keep) int32, -1 padded, and keep_valid (B, max_keep) bool."""
    b, n, _ = bev_boxes.shape
    dev = bev_boxes.device
    xs, zs = bev_corners_soa(bev_boxes)
    areas = (bev_boxes[..., 2] - bev_boxes[..., 0]) * (bev_boxes[..., 3] - bev_boxes[..., 1])
    alive = (torch.ones((b, n), dtype=torch.bool, device=dev) if valid_mask is None
             else valid_mask.bool().clone())
    ar = torch.arange(n, device=dev).expand(b, n)
    neg_inf = torch.full_like(scores, float("-inf"))
    keep = torch.full((b, max_keep), -1, dtype=torch.int32, device=dev)
    thresh = torch.tensor(iou_thresh, dtype=torch.float32, device=dev)
    for step in range(max_keep):
        key = torch.where(alive, scores, neg_inf)
        top = key.amax(dim=1, keepdim=True)
        best = torch.where(alive & (key == top), ar, n).amin(dim=1, keepdim=True)
        ok = best < n
        keep[:, step] = torch.where(ok[:, 0], best[:, 0], -1).to(torch.int32)
        sel = best.clamp(max=n - 1)
        s_xs = [x.gather(1, sel) for x in xs]
        s_zs = [z.gather(1, sel) for z in zs]
        s_area = areas.gather(1, sel)
        ov = edges_in_poly_integral(s_xs, s_zs, xs, zs, False)
        ov = ov + edges_in_poly_integral(xs, zs, s_xs, s_zs, True)
        ov = torch.clamp(0.5 * ov, min=0.0)
        iou = ov / torch.clamp(s_area + areas - ov, min=_EPS)
        suppress = (iou > thresh) | (ar == best)
        alive = alive & ~(ok & suppress)
    return keep, keep >= 0


def oriented_nms_boxes_3d(boxes_3d, scores, iou_thresh, max_keep, valid_mask=None):
    """`oriented_nms` on (B, N, 7) box_3d inputs."""
    return oriented_nms(boxes_3d_to_bev(boxes_3d), scores, iou_thresh, max_keep, valid_mask)


def pc_crop_and_sample(pts, fts, intensities, mask, boxes_corners, box_ind, resize):
    """`resize` points per oriented 3D box: the first points inside it in
    index order, repeated cyclically to fill. Returns crop_pts (Nb, R, 3),
    crop_fts (Nb, R, C), crop_intensities (Nb, R, 1), crop_mask (Nb, R),
    crop_ind (Nb, R) int32, non_empty_box_mask (Nb,)."""
    b, n, _ = pts.shape
    nb = boxes_corners.shape[0]
    box_ind = box_ind.long()
    inside = points_in_box_3d(pts[box_ind], boxes_corners)
    idx, cnt = first_k_true(inside, resize)
    slot = torch.arange(resize, device=pts.device)[None, :]
    wrapped = torch.where(cnt[:, None] > 0, slot % torch.clamp(cnt[:, None], min=1),
                          torch.zeros_like(slot))
    idx = torch.gather(idx, 1, wrapped.long())
    rows = (box_ind[:, None] * n + idx.long()).reshape(-1)
    crop_pts = pts.reshape(b * n, 3)[rows].reshape(nb, resize, 3)
    crop_int = intensities.reshape(b * n, 1)[rows].reshape(nb, resize, 1)
    crop_mask = mask.reshape(b * n)[rows].reshape(nb, resize)
    crop_fts = fts.reshape(b * n, fts.shape[-1])[rows].reshape(nb, resize, fts.shape[-1])
    return crop_pts, crop_fts, crop_int, crop_mask, idx, cnt > 0


def crop_and_resize(image, boxes_yxyx_norm, box_ind, crop_size: int):
    """tf.image.crop_and_resize: (B, H, W, C) image, (N, 4) normalised
    [y1, x1, y2, x2] boxes, (N,) batch indices -> (N, crop, crop, C)
    bilinear samples on a corner-aligned grid, 0 outside the image."""
    b, h, w, c = image.shape
    y1, x1, y2, x2 = (boxes_yxyx_norm[:, i] for i in range(4))
    if crop_size > 1:
        frac = torch.arange(crop_size, dtype=torch.float32, device=image.device) / (crop_size - 1)
    else:
        frac = torch.full((1,), 0.5, dtype=torch.float32, device=image.device)
    ys = (y1[:, None] + (y2 - y1)[:, None] * frac[None, :]) * (h - 1)
    xs = (x1[:, None] + (x2 - x1)[:, None] * frac[None, :]) * (w - 1)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    bi = box_ind.long()[:, None, None]

    def gather(yi, xi):
        valid = ((yi[:, :, None] >= 0) & (yi[:, :, None] <= h - 1)
                 & (xi[:, None, :] >= 0) & (xi[:, None, :] <= w - 1))
        yc = yi.clamp(0, h - 1).long()[:, :, None]
        xc = xi.clamp(0, w - 1).long()[:, None, :]
        return image[bi, yc, xc] * valid[..., None]

    p00 = gather(y0, x0)
    p01 = gather(y0, x0 + 1)
    p10 = gather(y0 + 1, x0)
    p11 = gather(y0 + 1, x0 + 1)
    top = p00 * (1 - wx) + p01 * wx
    bot = p10 * (1 - wx) + p11 * wx
    return top * (1 - wy) + bot * wy
