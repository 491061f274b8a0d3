"""Box geometry: corners, BEV boxes, point-in-box tests, canonical frames.

PyTorch port of heterofusionrcnn_tpu/core/geometry.py (same formats and
conventions, camera rectified frame, KITTI):

  box_3d : [x, y, z, l, w, h, ry], (x, y, z) the centre of the bottom face
      (y points down, the top face is at y - h); l along local x, w along
      local z, ry the rotation about the camera y axis.
  box_8c : (..., 8, 3) ordered corners P1..P8, P1..P4 on the bottom face.
  bev box: [x1, z1, x2, z2, ry], the axis-aligned extent before rotation.

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch

_CORNER_X_SIGNS = (1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0)
_CORNER_Z_SIGNS = (1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0)
_CORNER_Y_TOP = (0.0, 0.0, 0.0, 0.0, -1.0, -1.0, -1.0, -1.0)


def rotation_y(ry: torch.Tensor) -> torch.Tensor:
    """(...,) angles -> (..., 3, 3) matrices applied as `row @ R`:
    x' = x cos + z sin, z' = -x sin + z cos."""
    c, s = torch.cos(ry), torch.sin(ry)
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, zeros, -s], dim=-1),
            torch.stack([zeros, ones, zeros], dim=-1),
            torch.stack([s, zeros, c], dim=-1),
        ],
        dim=-2,
    )


def box_3d_to_corners(boxes_3d: torch.Tensor) -> torch.Tensor:
    """(..., 7) box_3d -> (..., 8, 3) ordered corners."""
    sx = boxes_3d.new_tensor(_CORNER_X_SIGNS)
    sz = boxes_3d.new_tensor(_CORNER_Z_SIGNS)
    sy = boxes_3d.new_tensor(_CORNER_Y_TOP)
    l, w, h, ry = (boxes_3d[..., i] for i in (3, 4, 5, 6))
    local = torch.stack(
        [0.5 * l[..., None] * sx, h[..., None] * sy, 0.5 * w[..., None] * sz],
        dim=-1,
    )
    rotated = torch.einsum("...kc,...cd->...kd", local, rotation_y(ry))
    return rotated + boxes_3d[..., None, 0:3]


def boxes_3d_to_bev(boxes_3d: torch.Tensor) -> torch.Tensor:
    """(..., 7) box_3d -> (..., 5) BEV box [x1, z1, x2, z2, ry]."""
    cu = boxes_3d[..., 0]
    cv = boxes_3d[..., 2]
    half_l = boxes_3d[..., 3] * 0.5
    half_w = boxes_3d[..., 4] * 0.5
    return torch.stack(
        [cu - half_l, cv - half_w, cu + half_l, cv + half_w, boxes_3d[..., 6]],
        dim=-1,
    )


def points_in_box_3d(
    points: torch.Tensor, corners: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """(..., N, 3) points x (..., 8, 3) corners -> (..., N) bool membership,
    by the u/v/w projection test from corner P2."""
    p2 = corners[..., 1, :]
    d = points - p2[..., None, :]

    def interval(axis):
        proj = torch.einsum("...nc,...c->...n", d, axis)
        sq = torch.sum(axis * axis, dim=-1)[..., None]
        return (proj >= -eps) & (proj <= sq + eps)

    return (
        interval(corners[..., 0, :] - p2)
        & interval(corners[..., 2, :] - p2)
        & interval(corners[..., 5, :] - p2)
    )


def canonical_transform(points: torch.Tensor, boxes_3d: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) points into each (..., 7) box's frame: translate by -centre,
    rotate by -ry."""
    shifted = points - boxes_3d[..., None, 0:3]
    return torch.einsum(
        "...nc,...cd->...nd", shifted, rotation_y(-boxes_3d[..., 6])
    )


def expand_box_3d(boxes_3d: torch.Tensor, context: float) -> torch.Tensor:
    """Grow l, w, h by 2*context and move the bottom face down by context."""
    x, y, z, l, w, h, ry = (boxes_3d[..., i] for i in range(7))
    return torch.stack(
        [x, y + context, z, l + 2.0 * context, w + 2.0 * context,
         h + 2.0 * context, ry],
        dim=-1,
    )
