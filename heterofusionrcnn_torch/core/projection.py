"""Camera projection (PyTorch port of heterofusionrcnn_tpu/core/projection.py):
boxes and anchors into the image, anchors onto the BEV map."""

from __future__ import annotations

import torch

from heterofusionrcnn_torch.core.geometry import box_3d_to_corners


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


def project_anchors_to_bev(anchors: torch.Tensor, bev_extents):
    """(N, 6) anchors [x, y, z, dim_x, dim_y, dim_z] -> their (N, 4)
    [x1, z1, x2, z2] footprints on the BEV map whose xz extents are
    ((min_x, max_x), (min_z, max_z)), and the same as a share of the map.
    The map's origin is its top-left corner: z is flipped, and both axes
    start at the extent's minimum."""
    (x_min, x_max), (z_min, z_max) = (
        (bev_extents[0][0], bev_extents[0][1]),
        (bev_extents[1][0], bev_extents[1][1]),
    )
    x, z = anchors[:, 0], anchors[:, 2]
    half_x, half_z = anchors[:, 3] / 2.0, anchors[:, 5] / 2.0
    corners = torch.stack([x - half_x, z_max - (z + half_z), x + half_x, z_max - (z - half_z)],
                          dim=1)
    corners = corners - corners.new_tensor([x_min, z_min, x_min, z_min])
    ranges = corners.new_tensor([x_max - x_min, z_max - z_min, x_max - x_min, z_max - z_min])
    return corners, corners / ranges


def project_anchors_to_image_space(anchors: torch.Tensor, calib_p2: torch.Tensor, image_shape):
    """(N, 6) anchors -> (N, 4) [x1, y1, x2, y2] image boxes around their 8
    projected axis-aligned corners, and the same divided by the image's
    [w, h] (`image_shape` is (h, w)). Not clipped, as the reference's anchor
    variant is not."""
    x, y, z = anchors[:, 0], anchors[:, 1], anchors[:, 2]
    hx, dy, hz = anchors[:, 3] / 2.0, anchors[:, 4], anchors[:, 5] / 2.0
    sx = anchors.new_tensor([1, 1, -1, -1, 1, 1, -1, -1])
    sz = anchors.new_tensor([1, -1, -1, 1, 1, -1, -1, 1])
    top = anchors.new_tensor([0, 0, 0, 0, 1, 1, 1, 1])
    corners = torch.stack([x[:, None] + hx[:, None] * sx, y[:, None] - dy[:, None] * top,
                           z[:, None] + hz[:, None] * sz], dim=-1)
    uv = rect_to_image(corners.reshape(1, -1, 3),
                       torch.as_tensor(calib_p2, dtype=anchors.dtype,
                                       device=anchors.device)[None]).reshape(-1, 8, 2)
    box = torch.stack([uv[..., 0].amin(1), uv[..., 1].amin(1), uv[..., 0].amax(1),
                       uv[..., 1].amax(1)], dim=1)
    h, w = image_shape[0], image_shape[1]
    return box, box / box.new_tensor([w, h, w, h])


def boxes_2d_to_yxyx(boxes_2d_norm: torch.Tensor) -> torch.Tensor:
    """xyxy -> yxyx for crop-and-resize."""
    return boxes_2d_norm[..., [1, 0, 3, 2]]
