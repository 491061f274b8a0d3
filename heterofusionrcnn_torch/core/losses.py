"""Loss functions (PyTorch port of heterofusionrcnn_tpu/core/losses.py).

Each loss is the elementwise loss times a scalar or classwise weight,
reduced over the last axis only; the models sum and normalise (by the
foreground count, with a guard against zero) at the call site, the bin
heads' through `bin_losses`.

Under data parallelism (a process group) a rank's loss is its share of the
global batch's: the sum over its own rows divided by the count over the
global batch, so that the ranks' shares add up to the one-process loss.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from heterofusionrcnn_torch.parallel.mesh import all_reduce_sum


def weighted_smooth_l1(prediction: torch.Tensor, target: torch.Tensor, weight=1.0) -> torch.Tensor:
    """Smooth L1 (Huber, delta 1) summed over the last axis: (..., D) -> (...)."""
    diff = prediction - target
    abs_diff = diff.abs()
    loss = torch.where(abs_diff < 1.0, 0.5 * diff * diff, abs_diff - 0.5)
    return loss.sum(-1) * weight


def weighted_softmax_ce(logits: torch.Tensor, onehot_labels: torch.Tensor, weight=1.0) -> torch.Tensor:
    """Softmax cross-entropy against (possibly smoothed) one-hot labels:
    (..., K) -> (...)."""
    return -(onehot_labels * torch.log_softmax(logits, dim=-1)).sum(-1) * weight


def weighted_focal(probs: torch.Tensor, onehot_labels: torch.Tensor, weight=1.0,
                   alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Focal loss on probabilities (already softmaxed), clipped to
    [1e-7, 1 - 1e-7]: alpha * t * (1 - p)^gamma * (-t * log p) summed over
    classes. The target appears squared, which matters for smoothed targets.
    (..., K) -> (...)."""
    eps = 1e-7
    p = probs.clamp(eps, 1.0 - eps)
    cross_entropy = -onehot_labels * torch.log(p)
    f_weight = alpha * onehot_labels * torch.pow(1.0 - p, gamma)
    return (f_weight * cross_entropy).sum(-1) * weight


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Float one-hot rows; a label outside [0, num_classes), such as the -1
    ignore label, gives a row of zeros (`jax.nn.one_hot`'s behaviour)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).float()


def one_hot_smooth(labels: torch.Tensor, num_classes: int, epsilon: float = 0.001) -> torch.Tensor:
    """One-hot with label smoothing: on = 1 - eps, off = eps / (K - 1)."""
    off = epsilon / (num_classes - 1)
    on = 1.0 - epsilon
    return one_hot(labels, num_classes) * (on - off) + off


def bin_losses(cls_preds, cls_gts, reg_preds, reg_gts, mask: torch.Tensor, lw,
               group: Optional[dist.ProcessGroup] = None):
    """The bin heads' losses over the rows of `mask` (float, 1 where a row
    counts): the bins' softmax cross-entropy and the residuals' smooth L1,
    each summed over the heads and normalised by the mask's count (0 when
    the count is 0). Shared by the RPN's `rpn_loss` and the RCNN's `rcnn_loss`.
    With a data-parallel `group` the count is the global batch's (this
    rank's share of the loss; a rank without rows of its own adds 0)."""
    num = all_reduce_sum(mask.sum(), group)
    safe = num.clamp(min=1.0)
    zero = torch.zeros((), device=mask.device)
    cls_loss = 0.0
    for logits, gt in zip(cls_preds, cls_gts):
        cls_loss = cls_loss + (weighted_softmax_ce(logits, gt, weight=lw.cls_loss_weight) * mask).sum()
    reg_loss = 0.0
    for pred, gt in zip(reg_preds, reg_gts):
        if pred.dim() == mask.dim():  # scalar residuals: add a feature axis
            pred, gt = pred[..., None], gt[..., None]
        reg_loss = reg_loss + (weighted_smooth_l1(pred, gt, weight=lw.reg_loss_weight) * mask).sum()
    return (torch.where(num > 0, cls_loss / safe, zero),
            torch.where(num > 0, reg_loss / safe, zero))
