"""Host-side numpy box geometry for the input pipeline and the KITTI writer.

Copy of the parts of heterofusionrcnn_tpu/utils/np_box_ops.py that the
port's data layer and writer use (`box_3d_to_corners`, `points_in_box`);
same semantics as the reference's box_8c_encoder.np_box_3d_to_box_8co and
obj_utils.is_point_inside.
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
