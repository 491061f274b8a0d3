"""Checkpoints of the port's models, in PyTorch's format.

The names of heterofusionrcnn_tpu/runtime/checkpoint.py `CheckpointManager`
(`save`, `restore`, `latest_step`, `all_steps`, `restore_raw`, `close`,
`max_to_keep` retention) and `restore_matching`, over a layout of its own:
one directory per step, `<directory>/<step>/checkpoint.pt`, holding
`{"state_dict": ..., "step": step}` with every tensor on the CPU, and for a
whole train state also `"optimizer"` (moments, update count and the
parameter EMA). A module's state dict is all that `run_inference` reads, so
either kind serves it. The JAX package's orbax checkpoints are not read
here. Under data parallelism every rank holds the same state: rank 0
writes it, and the others wait at a barrier until the file is in place.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from heterofusionrcnn_torch.parallel.mesh import rank_and_size

_FILE = "checkpoint.pt"


class CheckpointManager:
    """Per-step checkpoint directories, keeping the newest `max_to_keep`;
    with a data-parallel `group`, `save` is a collective of its ranks."""

    def __init__(self, directory: str, max_to_keep: int = 1000,
                 group: Optional[dist.ProcessGroup] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.group = group
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _FILE)

    def save(self, step: int, state: Any) -> None:
        """Save a train state (`runtime.train_state.TrainState`: module,
        optimizer, EMA), a module's state dict or a mapping of tensors at
        `step`. With a group, rank 0 writes and every rank returns once the
        checkpoint is in place."""
        if rank_and_size(self.group)[0] == 0:
            self._write(step, state)
        if self.group is not None:
            dist.barrier(group=self.group)

    def _write(self, step: int, state: Any) -> None:
        optimizer = getattr(state, "optimizer", None)
        state = getattr(state, "model", state)
        sd = state.state_dict() if isinstance(state, nn.Module) else state
        if not isinstance(sd, Mapping):
            raise TypeError("save takes a TrainState, an nn.Module or a state dict")
        payload = {"state_dict": _to_cpu(sd), "step": int(step)}
        if optimizer is not None:
            payload["optimizer"] = _to_cpu(optimizer.state_dict())
        path = self._path(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(self._path(int(name))):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load checkpoint `step` (the latest by default; none: unchanged)
        into a train state in place: module, optimizer and step."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state
        restored = self.restore_raw(step)
        if "optimizer" not in restored:
            raise KeyError(f"checkpoint {step} in {self.directory} holds no optimizer state")
        state.model.load_state_dict(restored["state_dict"])
        state.optimizer.load_state_dict(restored["optimizer"])
        state.step = int(restored["step"])
        return state

    def restore_raw(self, step: Optional[int] = None) -> dict:
        """{"state_dict", "step"} of `step` (the latest by default)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def close(self):
        """Nothing stays open; kept for the JAX manager's interface."""


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def restore_matching(target: Mapping[str, torch.Tensor],
                     source: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`target` with every tensor that `source` has under the same name and
    shape taken from `source` (a warm start, e.g. RPN -> RCNN: slim's
    `ignore_missing_vars`)."""
    out = {}
    for name, val in target.items():
        src = source.get(name)
        out[name] = src if src is not None and tuple(src.shape) == tuple(val.shape) else val
    return out
