"""Host-side numpy box geometry for the input pipeline and the KITTI writer.

Copy of heterofusionrcnn_tpu/utils/np_box_ops.py: `box_3d_to_corners` and
`points_in_box` (the reference's box_8c_encoder.np_box_3d_to_box_8co and
obj_utils.is_point_inside), the 3D / BEV IoU of box pairs that the RCNN
RoI sampling uses, one pair (`box_3d_iou_pair`) or many at once
(`box_3d_iou_pairs`), copied as they are: the sampled mini-batches depend
on these values bit for bit; and `indices_to_dense_vector`.
"""

from __future__ import annotations

import numpy as np

_X_SIGNS = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float32)
_Z_SIGNS = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float32)
_Y_TOP = np.array([0, 0, 0, 0, -1, -1, -1, -1], np.float32)


def box_3d_to_corners(boxes_3d: np.ndarray) -> np.ndarray:
    """box_3d (..., 7) -> ordered corners (..., 8, 3)."""
    boxes_3d = np.asarray(boxes_3d, np.float32)
    l, w, h, ry = (boxes_3d[..., i] for i in (3, 4, 5, 6))
    x_c = 0.5 * l[..., None] * _X_SIGNS
    z_c = 0.5 * w[..., None] * _Z_SIGNS
    y_c = h[..., None] * _Y_TOP
    c, s = np.cos(ry)[..., None], np.sin(ry)[..., None]
    xr = x_c * c + z_c * s
    zr = -x_c * s + z_c * c
    corners = np.stack([xr, y_c, zr], axis=-1)
    return corners + boxes_3d[..., None, 0:3]


def _clip_polygon(poly, p0, p1):
    """Clip polygon by the half-plane left of p0->p1 (CCW interior)."""
    out = []
    n = len(poly)
    ex, ez = p1[0] - p0[0], p1[1] - p0[1]
    for i in range(n):
        cur, nxt = poly[i], poly[(i + 1) % n]
        d_cur = ex * (cur[1] - p0[1]) - ez * (cur[0] - p0[0])
        d_nxt = ex * (nxt[1] - p0[1]) - ez * (nxt[0] - p0[0])
        if d_cur >= 0:
            out.append(cur)
        if (d_cur < 0 <= d_nxt) or (d_nxt < 0 <= d_cur):
            t = d_cur / (d_cur - d_nxt)
            out.append(cur + t * (nxt - cur))
    return out


def _bev_corners(box_3d):
    """BEV footprint corners (CCW) of one box_3d."""
    x, _, z, l, w, _, ry = box_3d
    c, s = np.cos(ry), np.sin(ry)
    pts = []
    for dx_s, dz_s in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
        dx, dz = dx_s * l / 2.0, dz_s * w / 2.0
        pts.append(np.array([dx * c + dz * s + x, -dx * s + dz * c + z]))
    return pts


def box_3d_iou_pair(box_a: np.ndarray, box_b: np.ndarray):
    """3D and BEV IoU of two boxes (host twin of core.rotated_iou.box_3d_iou;
    used by the RCNN RoI-noise retry loop, parity with
    hf/core/box_util.box3d_iou). Returns (iou_3d, iou_2d)."""
    poly = _bev_corners(box_a)
    clip = _bev_corners(box_b)
    for e in range(4):
        poly = _clip_polygon(poly, clip[e], clip[(e + 1) % 4])
        if not poly:
            break
    if len(poly) >= 3:
        pts = np.asarray(poly)
        x, z = pts[:, 0], pts[:, 1]
        inter = 0.5 * abs(np.dot(x, np.roll(z, -1)) - np.dot(z, np.roll(x, -1)))
    else:
        inter = 0.0

    area_a = box_a[3] * box_a[4]
    area_b = box_b[3] * box_b[4]
    iou_2d = inter / max(area_a + area_b - inter, 1e-8)

    ymax = min(box_a[1], box_b[1])
    ymin = max(box_a[1] - box_a[5], box_b[1] - box_b[5])
    inter_h = max(ymax - ymin, 0.0)
    inter_3d = inter * inter_h
    vol_a = area_a * box_a[5]
    vol_b = area_b * box_b[5]
    iou_3d = inter_3d / max(vol_a + vol_b - inter_3d, 1e-8)
    return iou_3d, iou_2d


def _bev_corners_batch(boxes_3d: np.ndarray) -> np.ndarray:
    """(M, 7) box_3d -> (M, 4, 2) CCW BEV footprints (batched _bev_corners)."""
    x, z = boxes_3d[:, 0], boxes_3d[:, 2]
    l, w = boxes_3d[:, 3], boxes_3d[:, 4]
    c, s = np.cos(boxes_3d[:, 6]), np.sin(boxes_3d[:, 6])
    signs = np.array([(-1, -1), (1, -1), (1, 1), (-1, 1)], np.float64)
    dx = signs[None, :, 0] * (l / 2.0)[:, None]  # (M, 4)
    dz = signs[None, :, 1] * (w / 2.0)[:, None]
    px = dx * c[:, None] + dz * s[:, None] + x[:, None]
    pz = -dx * s[:, None] + dz * c[:, None] + z[:, None]
    return np.stack([px, pz], axis=-1)


def box_3d_iou_pairs(boxes_a: np.ndarray, boxes_b: np.ndarray):
    """Elementwise 3D and BEV IoU of two (M, 7) box arrays -> ((M,), (M,)).

    Vectorized Sutherland-Hodgman with the same inside/intersection rules as
    the scalar `box_3d_iou_pair` (d_cur >= 0 keeps, strict/non-strict sign
    change inserts): each A footprint is clipped by the 4 half-planes of its
    B footprint. A convex quad gains at most one vertex per clip pass, so
    the slot count grows 4 -> 8 with per-pass compaction (stable argsort on
    the emit-validity mask). Used by the RCNN RoI-noise augmentation, which
    evaluates all its jitter candidates in one batch.
    """
    boxes_a = np.asarray(boxes_a, np.float64)
    boxes_b = np.asarray(boxes_b, np.float64)
    m = boxes_a.shape[0]
    if m == 0:
        z = np.zeros(0, np.float64)
        return z, z

    poly = _bev_corners_batch(boxes_a)          # (M, V, 2), V grows 4 -> 8
    mask = np.ones((m, 4), bool)
    cnt = np.full(m, 4, np.int64)
    clip = _bev_corners_batch(boxes_b)          # (M, 4, 2)
    rows = np.arange(m)[:, None]

    for e in range(4):
        p0 = clip[:, e]                          # (M, 2)
        p1 = clip[:, (e + 1) % 4]
        v = poly.shape[1]
        j = np.arange(v)[None, :]
        nxt_j = np.where(j + 1 < cnt[:, None], j + 1, 0)
        cur = poly
        nxt = poly[rows, nxt_j]
        ex = (p1[:, 0] - p0[:, 0])[:, None]
        ez = (p1[:, 1] - p0[:, 1])[:, None]
        d_cur = ex * (cur[..., 1] - p0[:, None, 1]) - ez * (
            cur[..., 0] - p0[:, None, 0]
        )
        d_nxt = ex * (nxt[..., 1] - p0[:, None, 1]) - ez * (
            nxt[..., 0] - p0[:, None, 0]
        )
        keep_cur = mask & (d_cur >= 0)
        crossed = mask & (((d_cur < 0) & (d_nxt >= 0)) | ((d_nxt < 0) & (d_cur >= 0)))
        denom = d_cur - d_nxt
        t = np.where(crossed, d_cur / np.where(crossed, denom, 1.0), 0.0)
        inter = cur + t[..., None] * (nxt - cur)

        # Interleave (cur, intersection) per input edge, then compact the
        # valid slots (stable sort keeps polygon order) into V + 1 slots.
        emitted = np.empty((m, 2 * v, 2), np.float64)
        emitted[:, 0::2] = cur
        emitted[:, 1::2] = inter
        emit_valid = np.empty((m, 2 * v), bool)
        emit_valid[:, 0::2] = keep_cur
        emit_valid[:, 1::2] = crossed
        order = np.argsort(~emit_valid, axis=1, kind="stable")[:, : v + 1]
        poly = emitted[rows, order]
        mask = np.take_along_axis(emit_valid, order, axis=1)
        cnt = emit_valid.sum(axis=1)

    # Shoelace over the valid prefix: pad tail slots with the last valid
    # vertex (duplicates contribute zero area).
    v = poly.shape[1]
    j = np.arange(v)[None, :]
    fill_j = np.minimum(j, np.maximum(cnt - 1, 0)[:, None])
    filled = poly[rows, fill_j]
    x, z = filled[..., 0], filled[..., 1]
    inter_area = 0.5 * np.abs(
        np.sum(x * np.roll(z, -1, axis=1) - z * np.roll(x, -1, axis=1), axis=1)
    )
    inter_area = np.where(cnt >= 3, inter_area, 0.0)

    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    iou_2d = inter_area / np.maximum(area_a + area_b - inter_area, 1e-8)

    ymax = np.minimum(boxes_a[:, 1], boxes_b[:, 1])
    ymin = np.maximum(boxes_a[:, 1] - boxes_a[:, 5], boxes_b[:, 1] - boxes_b[:, 5])
    inter_3d = inter_area * np.maximum(ymax - ymin, 0.0)
    vol_a = area_a * boxes_a[:, 5]
    vol_b = area_b * boxes_b[:, 5]
    iou_3d = inter_3d / np.maximum(vol_a + vol_b - inter_3d, 1e-8)
    return iou_3d, iou_2d


def points_in_box(points: np.ndarray, box_3d: np.ndarray, eps: float = 1e-6):
    """(N, 3) points inside one oriented box_3d -> (N,) bool mask.

    Same u/v/w interval test as the reference (obj_utils.is_point_inside
    :425-484), via the ordered corners.
    """
    corners = box_3d_to_corners(np.asarray(box_3d, np.float32))
    p2 = corners[1]
    u = corners[0] - p2
    v = corners[2] - p2
    w = corners[5] - p2
    d = points - p2

    def interval(axis):
        proj = d @ axis
        sq = float(axis @ axis)
        return (proj >= -eps) & (proj <= sq + eps)

    return interval(u) & interval(v) & interval(w)


def indices_to_dense_vector(
    indices, size, indices_value=1.0, default_value=0.0, dtype=np.float32
):
    """A dense vector of `size` holding `indices_value` at `indices` and
    `default_value` elsewhere."""
    out = np.full(int(size), default_value, dtype=dtype)
    out[np.asarray(indices, np.int64)] = indices_value
    return out
