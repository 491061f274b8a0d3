"""Camera projection of the port (`core/projection.py`): points and boxes
into the image."""

from __future__ import annotations

import torch

from hfbench.reference.geometry import box_3d_to_corners


def rect_to_image(pts3d: torch.Tensor, calib_p2: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) rect-frame points x (B, 3, 4) P2 -> (B, N, 2) pixels [u, v]."""
    hom = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], dim=-1)
    proj = torch.einsum("bij,bnj->bni", calib_p2, hom)
    return proj[..., :2] / proj[..., 2:3]


def project_boxes_to_image_space(
    boxes_3d: torch.Tensor, calib_p2: torch.Tensor, image_w: int, image_h: int
):
    """(B, n, 7) boxes -> clipped (B, n, 4) [x1, y1, x2, y2] image boxes and
    the same normalised to [0, 1]."""
    corners = box_3d_to_corners(boxes_3d)
    b, n = corners.shape[:2]
    uv = rect_to_image(corners.reshape(b, n * 8, 3), calib_p2).reshape(b, n, 8, 2)
    x1 = torch.clamp(uv[..., 0].amin(-1), 0.0, image_w)
    x2 = torch.clamp(uv[..., 0].amax(-1), 0.0, image_w)
    y1 = torch.clamp(uv[..., 1].amin(-1), 0.0, image_h)
    y2 = torch.clamp(uv[..., 1].amax(-1), 0.0, image_h)
    boxes_2d = torch.stack([x1, y1, x2, y2], dim=-1)
    scale = boxes_2d.new_tensor([image_w, image_h, image_w, image_h])
    return boxes_2d, boxes_2d / scale


def boxes_2d_to_yxyx(boxes_2d_norm: torch.Tensor) -> torch.Tensor:
    """xyxy -> yxyx for crop-and-resize."""
    return boxes_2d_norm[..., [1, 0, 3, 2]]
