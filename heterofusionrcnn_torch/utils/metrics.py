"""Proposal recall metrics (copy of heterofusionrcnn_tpu/utils/metrics.py,
the reference's box_util.compute_recall_iou :131-176): numpy on the host,
over IoU tables the RPN computed on the device."""

from __future__ import annotations

import numpy as np


def compute_recall_iou(
    pred_boxes_3d: np.ndarray,
    label_boxes_3d: np.ndarray,
    label_cls: np.ndarray,
    proposal_gt_iou2d: np.ndarray,
    proposal_gt_iou3d: np.ndarray,
):
    """Proposal recall / best-GT assignment.

    Args:
      pred_boxes_3d: (n, 7); label_boxes_3d: (m, 7); label_cls: (m,).
      proposal_gt_iou2d / 3d: (n, m) IoU tables.
    Returns:
      recall_50, recall_70 (counts of GTs recalled), iou2ds (n,), iou3ds (n,),
      iou3ds_gt_boxes (n, 7), iou3ds_gt_cls (n,), iou3d table (n, m).
    """
    n = pred_boxes_3d.shape[0]
    m = label_boxes_3d.shape[0]
    mx_iou2ds = proposal_gt_iou2d[:n, :m]
    mx_iou3ds = proposal_gt_iou3d[:n, :m]
    iou2ds = np.zeros(n, np.float32)
    iou3ds = np.zeros(n, np.float32)
    iou3ds_gt_boxes = np.zeros((n, 7), np.float32)
    iou3ds_gt_cls = np.zeros(n, np.float32)
    recall_50 = recall_70 = 0

    if m * n > 0:
        recall_50 = int(np.sum(np.max(mx_iou3ds, axis=0) > 0.5))
        recall_70 = int(np.sum(np.max(mx_iou3ds, axis=0) > 0.7))
        iou2ds = np.max(mx_iou2ds, axis=1)
        iou3ds = np.max(mx_iou3ds, axis=1)
        best = np.argmax(mx_iou3ds, axis=1)
        iou3ds_gt_boxes = label_boxes_3d[best]
        iou3ds_gt_cls = label_cls[best]

    return (
        recall_50,
        recall_70,
        iou2ds,
        iou3ds,
        iou3ds_gt_boxes,
        iou3ds_gt_cls,
        mx_iou3ds,
    )
