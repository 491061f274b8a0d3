"""Axis-aligned 2D box functions (PyTorch port of
heterofusionrcnn_tpu/core/box_2d.py) over (..., 4) [x1, y1, x2, y2]
tensors of any device.

The reference's dynamic-size prunes are mask-returning functions, as in
JAX: index with the mask to compact.
"""

from __future__ import annotations

import torch


def area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (...)."""
    return (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0))


def intersection(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection areas: (N, 4) x (M, 4) -> (N, M)."""
    x1 = torch.maximum(boxes_a[:, None, 0], boxes_b[None, :, 0])
    y1 = torch.maximum(boxes_a[:, None, 1], boxes_b[None, :, 1])
    x2 = torch.minimum(boxes_a[:, None, 2], boxes_b[None, :, 2])
    y2 = torch.minimum(boxes_a[:, None, 3], boxes_b[None, :, 3])
    return torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)


def iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: (N, 4) x (M, 4) -> (N, M)."""
    inter = intersection(boxes_a, boxes_b)
    union = area(boxes_a)[:, None] + area(boxes_b)[None, :] - inter
    return inter / torch.clamp(union, min=1e-8)


def ioa(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Intersection over the area of B: (N, 4) x (M, 4) -> (N, M)."""
    inter = intersection(boxes_a, boxes_b)
    return inter / torch.clamp(area(boxes_b)[None, :], min=1e-8)


def clip_to_window(boxes: torch.Tensor, window) -> torch.Tensor:
    """Clip boxes to [x_min, y_min, x_max, y_max]."""
    x_min, y_min, x_max, y_max = window
    return torch.stack(
        [
            torch.clamp(boxes[..., 0], x_min, x_max),
            torch.clamp(boxes[..., 1], y_min, y_max),
            torch.clamp(boxes[..., 2], x_min, x_max),
            torch.clamp(boxes[..., 3], y_min, y_max),
        ],
        dim=-1,
    )


def scale(boxes: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    return boxes * boxes.new_tensor([sx, sy, sx, sy])


def height_width(boxes: torch.Tensor):
    """(..., 4) -> (height (...,), width (...,))."""
    return boxes[..., 3] - boxes[..., 1], boxes[..., 2] - boxes[..., 0]


def matched_intersection(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Intersection areas of corresponding boxes: (N, 4) x (N, 4) -> (N,)."""
    x1 = torch.maximum(boxes_a[..., 0], boxes_b[..., 0])
    y1 = torch.maximum(boxes_a[..., 1], boxes_b[..., 1])
    x2 = torch.minimum(boxes_a[..., 2], boxes_b[..., 2])
    y2 = torch.minimum(boxes_a[..., 3], boxes_b[..., 3])
    return torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)


def matched_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU of corresponding boxes; 0 where they do not intersect."""
    inter = matched_intersection(boxes_a, boxes_b)
    union = area(boxes_a) + area(boxes_b) - inter
    return torch.where(inter > 0, inter / torch.clamp(union, min=1e-12),
                       torch.zeros_like(inter))


def sq_dist(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances between boxes as 4-d points: (N, 4) x
    (M, 4) -> (N, M)."""
    sq_a = torch.sum(boxes_a * boxes_a, dim=-1, keepdim=True)
    sq_b = torch.sum(boxes_b * boxes_b, dim=-1, keepdim=True)
    return sq_a + sq_b.T - 2.0 * boxes_a @ boxes_b.T


def change_coordinate_frame(boxes: torch.Tensor, window) -> torch.Tensor:
    """Boxes relative to `window` [x_min, y_min, x_max, y_max]: its min
    corner maps to (0, 0), its max corner to (1, 1)."""
    x_min, y_min, x_max, y_max = window
    shifted = boxes - boxes.new_tensor([x_min, y_min, x_min, y_min])
    return scale(shifted, 1.0 / (x_max - x_min), 1.0 / (y_max - y_min))


def prune_small_boxes_mask(boxes: torch.Tensor, min_side) -> torch.Tensor:
    """True for boxes with both sides >= min_side."""
    h, w = height_width(boxes)
    return (w >= min_side) & (h >= min_side)


def prune_non_overlapping_mask(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                               min_overlap: float = 0.0) -> torch.Tensor:
    """True for each box of A whose intersection with at least one box of
    B covers >= min_overlap of the A box's area."""
    return torch.amax(ioa(boxes_b, boxes_a), dim=0) >= min_overlap
