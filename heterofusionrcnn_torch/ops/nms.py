"""Oriented (rotated BEV) greedy NMS over a batch of frames.

Port of heterofusionrcnn_tpu/ops/nms.py (`oriented_nms`,
`oriented_nms_boxes_3d`). Where the JAX models vmap a one-frame NMS over
the batch, these functions take the batch, through the custom op
`hfr::oriented_nms`: on CUDA tensors every frame runs in one launch of the
kernel of `csrc/nms.cu`, each frame on a thread-block cluster whose size
`nms_plan` picks on the card it runs on; on CPU tensors
`oriented_nms_plain` runs.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from heterofusionrcnn_torch.core.geometry import boxes_3d_to_bev
from heterofusionrcnn_torch.core.rotated_iou import _EPS, bev_corners_soa, edges_in_poly_integral
from heterofusionrcnn_torch.ops.dispatch import (
    F,
    I,
    P,
    CudaKernel,
    cluster_plan,
    cluster_threads,
    one_device,
    pointers,
    sm_count,
)

NMS_KERNEL = CudaKernel(
    "nms.cu",
    {"hfr_nms": [P, P, P, P, I, I, I, F, I, I], "hfr_nms_clusters": [I, I, I]},
    exact=True,
)
# Boxes a CTA takes before a frame is spread over a larger cluster (one a
# thread: a box's IoU is ~1130 operations, worth a thread of its own).
NMS_BOXES_PER_CTA = 576
# Boxes whose centre, cos, sin and extents (24 bytes each) fit in one CTA's
# shared memory on Hopper (227 KB) beside the cluster argmax's slots (~3 KB).
NMS_MAX_SHARE = (232448 - 4096) // 24


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
    keep = torch.ops.hfr.oriented_nms(bev_boxes, scores, float(iou_thresh), max_keep, valid_mask)
    return keep, keep >= 0


@torch.library.custom_op("hfr::oriented_nms", mutates_args=(), device_types="cpu")
def _nms_op(bev_boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float, max_keep: int,
            valid_mask: Optional[torch.Tensor]) -> torch.Tensor:
    return oriented_nms_plain(bev_boxes, scores, iou_thresh, max_keep, valid_mask)


@_nms_op.register_kernel("cuda")
def _nms_cuda(bev_boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float, max_keep: int,
              valid_mask: Optional[torch.Tensor]) -> torch.Tensor:
    one_device(bev_boxes, scores, valid_mask)
    return _nms_kernel(bev_boxes, scores, iou_thresh, max_keep, valid_mask)


@_nms_op.register_fake
def _nms_fake(bev_boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float, max_keep: int,
              valid_mask: Optional[torch.Tensor]) -> torch.Tensor:
    one_device(bev_boxes, scores, valid_mask)
    return bev_boxes.new_empty((bev_boxes.shape[0], max_keep), dtype=torch.int32)


def nms_plan(b: int, n: int, sms: int, fits) -> Tuple[int, int]:
    """(cluster size, threads a CTA) of the kernel for b frames of n boxes
    on a card of `sms` SMs; `fits(c, threads)` is the kernel's occupancy
    query. The cluster is at least large enough for each CTA's share to fit
    its shared memory."""
    least = 1
    while -(-n // least) > NMS_MAX_SHARE:
        least *= 2
    return cluster_plan(b, n, sms, NMS_BOXES_PER_CTA, 1, fits, least)


@functools.lru_cache(maxsize=None)
def _launch_plan(b: int, n: int, device: torch.device) -> Tuple[int, int]:
    """`nms_plan` on `device` with the kernel's occupancy query, once per shape."""
    return nms_plan(b, n, sm_count(device), lambda c, t: nms_clusters(n, c, t) > 0)


@functools.lru_cache(maxsize=None)
def nms_clusters(n: int, cluster: int, threads: int) -> int:
    """Clusters of the kernel's launch for frames of n boxes that fit on the
    card at once (0: none)."""
    fit = NMS_KERNEL.load().hfr_nms_clusters(n, cluster, threads)
    if fit < 0:
        raise RuntimeError(f"nms: occupancy query failed ({-fit}) at N={n} cluster={cluster}")
    return fit


def _nms_kernel(bev_boxes, scores, iou_thresh, max_keep, valid_mask,
                cluster: Optional[int] = None, threads: Optional[int] = None) -> torch.Tensor:
    """One launch of the kernel, each frame on a cluster of `cluster` CTAs
    of `threads` threads (default: `nms_plan`'s choice; for a given cluster,
    one box a thread up to 1024); returns keep_idx."""
    b, n, _ = bev_boxes.shape
    if n > 32 * 1024 or max_keep < 1:
        raise ValueError(f"nms kernel takes N <= 32768 boxes per frame and max_keep >= 1, "
                         f"got N={n} max_keep={max_keep}")
    if cluster is None:
        cluster, threads = _launch_plan(b, n, bev_boxes.device)
    threads = threads or cluster_threads(n, cluster)
    boxes = bev_boxes.float().contiguous()
    sc = scores.float().contiguous()
    valid = None if valid_mask is None else valid_mask.to(torch.uint8).contiguous()
    keep = torch.empty((b, max_keep), dtype=torch.int32, device=boxes.device)
    NMS_KERNEL.launch(
        "hfr_nms", *pointers(boxes, sc, valid, keep),
        I(b), I(n), I(max_keep), F(iou_thresh), I(cluster), I(threads),
    )
    return keep


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
