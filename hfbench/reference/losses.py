"""Loss functions of the port (`core/losses.py`), one process.

Each loss is the elementwise loss times a scalar or classwise weight,
reduced over the last axis only; the models sum and normalise (by the
foreground count, with a guard against zero) at the call site, the bin
heads' through `bin_losses`.
"""

from __future__ import annotations

import torch


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


def bin_losses(cls_preds, cls_gts, reg_preds, reg_gts, mask: torch.Tensor, lw):
    """The bin heads' losses over the rows of `mask` (float, 1 where a row
    counts): the bins' softmax cross-entropy and the residuals' smooth L1,
    each summed over the heads and normalised by the mask's count (0 when
    the count is 0). """
    num = mask.sum()
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
