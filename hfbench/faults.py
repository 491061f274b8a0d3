"""Faults planted underneath the timed path, each of which a run's check
must catch (`correct` false): the CPU tests plant them in small runs, and
`readings.py --fault` on the card at a cell's own size.

Each fault takes a patcher with `setattr(obj, name, value)` (pytest's
`monkeypatch`, or `Patcher` below) and the cell's entry kind and model.
"""

from __future__ import annotations

import importlib

import torch

SERVE_MODELS = {"two_stage": ("heterofusionrcnn_torch.inference", "TwoStageDetector"),
                "rpn": ("heterofusionrcnn_torch.models.rpn", "RpnModel")}


class Patcher:
    """setattr that `undo()` reverses."""

    def __init__(self):
        self._saved = []

    def setattr(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)


def _wrap_forward(mp, model: str, change) -> None:
    mod, name = SERVE_MODELS[model]
    cls = getattr(importlib.import_module(mod), name)
    orig = cls.forward

    def forward(self, *args, **kwargs):
        return change(orig, self, *args, **kwargs)

    mp.setattr(cls, "forward", forward)


def altered_answer(mp, model: str) -> None:
    """An answer altered where it is produced: one box of the first frame
    moved 0.5 m."""
    def change(orig, self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        key = "final_boxes" if "final_boxes" in out else "proposals"
        out[key] = out[key].clone()
        out[key][0, 0, 0] += 0.5
        return out

    _wrap_forward(mp, model, change)


def half_batch_served(mp, model: str) -> None:
    """Half of the batch left out: the first half's outputs stand for all."""
    def change(orig, self, pc, img, p2, *rest, **kwargs):
        h = pc.shape[0] // 2
        out = orig(self, pc[:h], img[:h], p2[:h], *rest, **kwargs)
        return {k: torch.cat([v, v]) for k, v in out.items()}

    _wrap_forward(mp, model, change)


def stale_outputs(mp, model: str) -> None:
    """A step that returns its state unchanged: every call gives the first
    call's outputs."""
    def change(orig, self, *args, **kwargs):
        if not hasattr(self, "_stale_out"):
            self._stale_out = orig(self, *args, **kwargs)
        return self._stale_out

    _wrap_forward(mp, model, change)


def unchanged_state(mp, model: str) -> None:
    """A train step that leaves its parameters as they were."""
    from heterofusionrcnn_torch.runtime import optimizer

    mp.setattr(optimizer.Optimizer, "step", lambda self, grads: None)


def half_batch_trained(mp, model: str) -> None:
    """Half of the batch left out, the mean taken over the rest."""
    from heterofusionrcnn_torch.runtime import train_state

    orig = train_state.make_rpn_train_step

    def make(loss_fn):
        step = orig(loss_fn)
        return lambda state, batch: step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    mp.setattr(train_state, "make_rpn_train_step", make)


def altered_loss(mp, model: str) -> None:
    """An answer altered where it is produced: the segmentation loss 1%
    high."""
    from heterofusionrcnn_torch.models import rpn

    orig = rpn.rpn_loss

    def loss(preds, config, group=None):
        d, total = orig(preds, config, group)
        return dict(d, rpn_seg_loss=d["rpn_seg_loss"] * 1.01), total + 0.01 * d["rpn_seg_loss"]

    mp.setattr(rpn, "rpn_loss", loss)


FAULTS = {
    "serve": {f.__name__: f for f in (altered_answer, half_batch_served, stale_outputs)},
    "train": {f.__name__: f for f in (unchanged_state, half_batch_trained, altered_loss)},
}
