"""Unordered / facet box-corner codecs and facet-based point labelling
(numpy copy of heterofusionrcnn_tpu/core/box_8c.py, over the port's
`utils.np_box_ops.box_3d_to_corners`).

  - np_box_3d_to_box_8c: unordered corners by the nearest-90-degree ortho
    rotation, for order-free comparisons.
  - align_boxes_8c: skewed regressed corners snapped to an axis-consistent
    box.
  - box_8co_to_facet: ordered corners -> 6 inward-pointing face planes.
  - point_inside_facet / label_point_cloud_v2: convex-hull point labelling,
    vectorised; where a point lies in several boxes the first box wins.

Corner order (as `utils.np_box_ops.box_3d_to_corners`): x signs
[+,+,-,-,+,+,-,-] * l/2, z signs [+,-,-,+,+,-,-,+] * w/2, the first four
corners at the bottom (y = box y; camera y points down), the last four at
y - h.
"""

from __future__ import annotations

import numpy as np

from heterofusionrcnn_torch.utils.np_box_ops import box_3d_to_corners

# Face definitions (i, j, k, s): three corners spanning the face + one
# off-face corner used to orient the normal inwards.
_FACES = (
    (0, 1, 2, 5),  # bottom
    (1, 2, 6, 0),  # -z side
    (4, 5, 6, 1),  # top
    (2, 3, 7, 5),  # -x side
    (3, 0, 4, 1),  # +z side
    (0, 1, 5, 3),  # +x side
)


def np_box_3d_to_box_8c(box_3d: np.ndarray) -> np.ndarray:
    """box_3d (7,) -> UNORDERED corners (3, 8) via ortho rotation.

    The box is first converted to an axis-aligned anchor at the nearest
    90-degree heading (dims re-projected onto the axes), then the residual
    rotation ry - ortho_ry is applied. Corner order is therefore NOT
    heading-stable — use only for order-free comparisons.
    """
    box_3d = np.asarray(box_3d, np.float64).reshape(7)
    x, y, z, l, w, h, ry = box_3d
    half_pi = np.pi / 2
    ortho_ry = np.round(ry / half_pi) * half_pi
    cos_o, sin_o = np.abs(np.cos(ortho_ry)), np.abs(np.sin(ortho_ry))
    dim_x = l * cos_o + w * sin_o
    dim_y = h
    dim_z = w * cos_o + l * sin_o

    hx, hz = dim_x / 2.0, dim_z / 2.0
    x_c = np.array([hx, hx, -hx, -hx, hx, hx, -hx, -hx])
    y_c = np.array([0.0, 0.0, 0.0, 0.0, -dim_y, -dim_y, -dim_y, -dim_y])
    z_c = np.array([hz, -hz, -hz, hz, hz, -hz, -hz, hz])

    ry_diff = ry - ortho_ry
    c, s = np.cos(ry_diff), np.sin(ry_diff)
    xr = c * x_c + s * z_c + x
    yr = y_c + y
    zr = -s * x_c + c * z_c + z
    return np.stack([xr, yr, zr], axis=0)


def align_boxes_8c(boxes_8c: np.ndarray) -> np.ndarray:
    """Snap skewed corners to an axis-consistent box (N, 3, 8) -> (N, 3, 8).

    Per the corner convention: x takes the max for corners {0,1,4,5} and min
    for {2,3,6,7}; z takes the max for {0,3,4,7} and min for {1,2,5,6}; y
    takes the max (bottom, y down) for {0..3} and min for {4..7}.
    """
    b = np.asarray(boxes_8c, np.float64)
    if b.ndim == 2:
        b = b[None]
    out = np.empty_like(b)
    min_x = b[:, 0].min(axis=1, keepdims=True)
    max_x = b[:, 0].max(axis=1, keepdims=True)
    min_y = b[:, 1].min(axis=1, keepdims=True)
    max_y = b[:, 1].max(axis=1, keepdims=True)
    min_z = b[:, 2].min(axis=1, keepdims=True)
    max_z = b[:, 2].max(axis=1, keepdims=True)
    x_sign = np.array([1, 1, -1, -1, 1, 1, -1, -1]) > 0
    z_sign = np.array([1, -1, -1, 1, 1, -1, -1, 1]) > 0
    y_bottom = np.array([1, 1, 1, 1, 0, 0, 0, 0]) > 0
    out[:, 0] = np.where(x_sign, max_x, min_x)
    out[:, 1] = np.where(y_bottom, max_y, min_y)
    out[:, 2] = np.where(z_sign, max_z, min_z)
    return out if np.asarray(boxes_8c).ndim == 3 else out[0]


def box_8co_to_facet(boxes_8co: np.ndarray) -> np.ndarray:
    """Ordered corners (N, 8, 3) -> face planes (N, 6, 7).

    Each row is [a, b, c, d, ax, ay, az]: inward normal (a, b, c), plane
    offset d with a*x + b*y + c*z + d = 0, and an anchor point on the face
    (the reference stores the same 7-column layout,
    box_8c_encoder.np_box_8co_to_facet :379-414).
    """
    b = np.asarray(boxes_8co, np.float64)
    if b.ndim == 2:
        b = b[None]
    rows = []
    for i, j, k, s in _FACES:
        n = np.cross(b[:, k] - b[:, j], b[:, j] - b[:, i])
        toward_s = np.einsum("nc,nc->n", b[:, s] - b[:, j], n) > 0
        n = n * (toward_s * 2.0 - 1.0)[:, None]
        d = -np.einsum("nc,nc->n", b[:, j], n)[:, None]
        rows.append(np.concatenate([n, d, b[:, j]], axis=1))
    out = np.stack(rows, axis=1)
    return out if np.asarray(boxes_8co).ndim == 3 else out[0]


def point_inside_facet(points: np.ndarray, facets: np.ndarray) -> np.ndarray:
    """Convex-hull membership: points (N, 3) x facets (M, 6, 7) -> (N, M)
    bool. Inside iff dot(normal, point - anchor) >= 0 for all six faces
    (reference point_inside_facet :213-228, vectorized)."""
    points = np.asarray(points, np.float64)
    facets = np.asarray(facets, np.float64)
    if facets.ndim == 2:
        facets = facets[None]
    norms = facets[..., 0:3]     # (M, 6, 3)
    anchors = facets[..., 4:7]   # (M, 6, 3)
    proj = np.einsum("mfc,nc->nmf", norms, points)
    offs = np.einsum("mfc,mfc->mf", norms, anchors)
    return (proj >= offs[None]).all(axis=-1)


def label_point_cloud_v2(
    points: np.ndarray, boxes_3d: np.ndarray, klasses: np.ndarray
) -> np.ndarray:
    """Facet-based point labeling (reference label_seg_utils.
    label_point_cloud_v2 :153-228, vectorized).

    Args:
      points: (N, 3); boxes_3d: (M, 7); klasses: (M,) 1-based classes.
    Returns:
      (N, 8) rows [klass, x, y, z, l, w, h, ry]; klass 0 = background.
      When a point falls in several boxes the FIRST box in input order wins
      (matches the reference's skip-if-already-labeled loop).
    """
    points = np.asarray(points, np.float64)
    boxes_3d = np.asarray(boxes_3d, np.float64).reshape(-1, 7)
    n = points.shape[0]
    label_seg = np.zeros((n, 8), np.float32)
    if boxes_3d.shape[0] == 0:
        return label_seg

    corners = box_3d_to_corners(boxes_3d)          # (M, 8, 3) ordered
    facets = box_8co_to_facet(corners)             # (M, 6, 7)
    inside = point_inside_facet(points, facets)    # (N, M)
    has = inside.any(axis=1)
    first = np.argmax(inside, axis=1)              # first True per point
    klass = np.asarray(klasses, np.float32)[first]
    label_seg[:, 0] = np.where(has, klass, 0.0)
    label_seg[:, 1:8] = np.where(
        has[:, None], boxes_3d[first].astype(np.float32), 0.0
    )
    return label_seg
