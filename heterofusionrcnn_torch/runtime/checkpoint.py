"""Checkpoints of the port's models, in PyTorch's format.

The names of heterofusionrcnn_tpu/runtime/checkpoint.py `CheckpointManager`
(`save`, `latest_step`, `all_steps`, `restore_raw`, `close`, `max_to_keep`
retention), over a layout of its own: one directory per step,
`<directory>/<step>/checkpoint.pt`, holding `{"state_dict": ..., "step":
step}` with every tensor on the CPU. The JAX package's orbax checkpoints
are not read here.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Mapping, Optional

import torch
from torch import nn

_FILE = "checkpoint.pt"


class CheckpointManager:
    """Per-step checkpoint directories, keeping the newest `max_to_keep`."""

    def __init__(self, directory: str, max_to_keep: int = 1000):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _FILE)

    def save(self, step: int, state: Any) -> None:
        """Save a module's state dict (or a mapping of tensors) at `step`."""
        sd = state.state_dict() if isinstance(state, nn.Module) else state
        if not isinstance(sd, Mapping):
            raise TypeError("save takes an nn.Module or a state dict")
        payload = {"state_dict": {k: v.detach().cpu() for k, v in sd.items()},
                   "step": int(step)}
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

    def restore_raw(self, step: Optional[int] = None) -> dict:
        """{"state_dict", "step"} of `step` (the latest by default)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def close(self):
        """Nothing stays open; kept for the JAX manager's interface."""
