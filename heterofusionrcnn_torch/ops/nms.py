"""Oriented (rotated BEV) greedy NMS over a batch of frames.

Port of heterofusionrcnn_tpu/ops/nms.py (`oriented_nms`,
`oriented_nms_boxes_3d`). Where the JAX models vmap a one-frame NMS over
the batch, these functions take the batch: on CUDA tensors every frame runs
in one launch of the kernel of `csrc/nms.cu`; on CPU tensors
`oriented_nms_plain` runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from heterofusionrcnn_torch.core.geometry import boxes_3d_to_bev
from heterofusionrcnn_torch.core.rotated_iou import _EPS, bev_corners_soa, edges_in_poly_integral
from heterofusionrcnn_torch.ops.dispatch import F, I, P, CudaKernel, pointers, use_kernel

NMS_KERNEL = CudaKernel(
    "nms.cu", {"hfr_nms": [P, P, P, P, P, I, I, I, F]}, exact=True
)


def oriented_nms(
    bev_boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_thresh: float,
    max_keep: int,
    valid_mask: Optional[torch.Tensor] = None,
):
    """Greedy rotated-rectangle NMS per frame.

    Args:
      bev_boxes: (B, N, 5) [x1, z1, x2, z2, ry]; scores: (B, N).
      iou_thresh: suppress boxes with IoU > thresh against a kept box.
      max_keep: output slots per frame.
      valid_mask: optional (B, N) bool; False entries are never kept.
    Returns:
      keep_idx (B, max_keep) int32, -1 padded, in keep order (descending
      score, lowest index on ties); keep_valid (B, max_keep) bool.
    """
    b, n, _ = bev_boxes.shape
    if not use_kernel(bev_boxes, scores):
        keep = oriented_nms_plain(bev_boxes, scores, iou_thresh, max_keep, valid_mask)
        return keep, keep >= 0
    if n > 32 * 1024:
        raise ValueError(f"nms kernel takes N <= 32768 boxes per frame, got {n}")
    boxes = bev_boxes.float().contiguous()
    sc = scores.float().contiguous()
    valid = None if valid_mask is None else valid_mask.to(torch.uint8).contiguous()
    quads = torch.empty((b, n, 9), dtype=torch.float32, device=boxes.device)
    keep = torch.empty((b, max_keep), dtype=torch.int32, device=boxes.device)
    NMS_KERNEL.launch(
        "hfr_nms", *pointers(boxes, sc, valid, quads, keep),
        I(b), I(n), I(max_keep), F(iou_thresh),
    )
    return keep, keep >= 0


def oriented_nms_plain(bev_boxes, scores, iou_thresh, max_keep, valid_mask=None):
    """Plain PyTorch greedy NMS with the kernel's selection rule and IoU
    arithmetic; returns keep_idx (B, max_keep) int32."""
    b, n, _ = bev_boxes.shape
    dev = bev_boxes.device
    xs, zs = bev_corners_soa(bev_boxes)
    areas = (bev_boxes[..., 2] - bev_boxes[..., 0]) * (bev_boxes[..., 3] - bev_boxes[..., 1])
    alive = (
        torch.ones((b, n), dtype=torch.bool, device=dev)
        if valid_mask is None
        else valid_mask.bool().clone()
    )
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
    return keep


def oriented_nms_boxes_3d(boxes_3d, scores, iou_thresh, max_keep, valid_mask=None):
    """`oriented_nms` on (B, N, 7) box_3d inputs."""
    return oriented_nms(boxes_3d_to_bev(boxes_3d), scores, iou_thresh, max_keep, valid_mask)
