"""The rotated-rectangle BEV overlap of the port's NMS (`core/rotated_iou.py`,
Green's-theorem form). The overlap of
two convex rectangles is half the line integral of (x dz - z dx) around the
boundary of their intersection: each rectangle's edges clipped to the
other, each clip one interval [t0, t1] found by four branch-free
half-plane tests. A segment lying on a clip edge in the same direction is
dropped on the second pass, so shared boundaries count once.

This is also the plain version of the IoU inside the oriented-NMS kernel
(ops/csrc/nms.cu): the expressions below keep the kernel's operation order.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def bev_corners_soa(boxes: torch.Tensor):
    """(..., 5) BEV boxes -> (4 x-lists, 4 z-lists) of (...) corners, CCW in
    (x, z) from (x1, z1)."""
    x1, z1, x2, z2, ry = (boxes[..., i] for i in range(5))
    cx = 0.5 * (x1 + x2)
    cz = 0.5 * (z1 + z2)
    c = torch.cos(ry)
    s = torch.sin(ry)
    xs, zs = [], []
    for dx_sign, dz_sign in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
        dx = dx_sign * 0.5 * (x2 - x1)
        dz = dz_sign * 0.5 * (z2 - z1)
        xs.append(dx * c + dz * s + cx)
        zs.append(-dx * s + dz * c + cz)
    return xs, zs


def edges_in_poly_integral(ax, az, bx, bz, drop_same_dir_collinear=False):
    """Sum over A's edges of (t1 - t0) * cross(P, Q), each edge clipped to
    the CCW rectangle B. Inputs are lists of 4 broadcastable tensors."""
    total = 0.0
    for e in range(4):
        px, pz = ax[e], az[e]
        qx, qz = ax[(e + 1) % 4], az[(e + 1) % 4]
        t0 = torch.zeros_like(px + bx[0])
        t1 = torch.ones_like(t0)
        for h in range(4):
            hx0, hz0 = bx[h], bz[h]
            ex = bx[(h + 1) % 4] - hx0
            ez = bz[(h + 1) % 4] - hz0
            d0 = ex * (pz - hz0) - ez * (px - hx0)
            d1 = ex * (qz - hz0) - ez * (qx - hx0)
            denom = d0 - d1
            t_cross = d0 / torch.where(denom.abs() > _EPS, denom, torch.ones_like(denom))
            entering = (d0 < 0) & (d1 >= 0)
            leaving = (d0 >= 0) & (d1 < 0)
            both_out = (d0 < 0) & (d1 < 0)
            if drop_same_dir_collinear:
                collinear = (d0.abs() <= _EPS) & (d1.abs() <= _EPS)
                same_dir = (qx - px) * ex + (qz - pz) * ez > 0
                both_out = both_out | (collinear & same_dir)
            t0 = torch.maximum(t0, torch.where(entering, t_cross, torch.zeros_like(t_cross)))
            t1 = torch.minimum(t1, torch.where(leaving, t_cross, torch.ones_like(t_cross)))
            t1 = torch.where(both_out, torch.full_like(t1, -1.0), t1)
        span = torch.clamp(t1 - t0, min=0.0)
        total = total + span * (px * qz - pz * qx)
    return total
