"""Optimizer (PyTorch port of heterofusionrcnn_tpu/runtime/optimizer.py).

The JAX package's optax chain as one object: global-norm clipping, then
Adam (or momentum, SGD, RMSProp) over an exponential-decay learning rate
whose initial value is scaled by the data-parallel world size, then an
exponential moving average of the parameters the step produces (chained
last). Each part computes what its optax transform computes:

  - clip: g * max / ||g|| where the global norm ||g|| is at least `max`
    (optax's form, no epsilon: `clip_grad_norm_` would add 1e-6);
  - the learning rate at the count of updates made *before* this one;
  - Adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
    correction at the count after this update;
  - momentum / SGD: `optax.sgd` (trace g + m * t, then the rate);
    RMSProp: `optax.rmsprop` defaults (decay 0.9, eps 1e-8 inside the
    square root, no bias correction), the rate, then the trace.

BatchNorm statistics are buffers and are not optimised or averaged.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from heterofusionrcnn_torch.configs.config import OptimizerConfig
from heterofusionrcnn_torch.runtime import tracing

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RMS_DECAY, RMS_EPS = 0.9, 1e-8


def build_lr_schedule(cfg: OptimizerConfig, world_size: int = 1):
    """count -> learning rate (float32): initial LR x world size, decayed
    by `decay_factor` every `decay_steps` (continuously unless staircase)."""
    init = cfg.initial_learning_rate * world_size

    def schedule(count: int) -> np.float32:
        if cfg.decay_steps <= 0 or cfg.decay_factor == 0 or count <= 0:
            return np.float32(init)
        p = np.float32(count) / np.float32(cfg.decay_steps)
        if cfg.staircase:
            p = np.floor(p)
        return np.float32(init) * np.power(np.float32(cfg.decay_factor), p, dtype=np.float32)

    return schedule


class Optimizer:
    """Clip -> base optimizer -> parameter EMA over `named_params`, updated
    in place by `step(grads)`."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], cfg: OptimizerConfig,
                 world_size: int = 1, grad_clip_norm: float = 1.0):
        if cfg.optimizer_type not in ("adam", "momentum", "sgd", "rmsprop"):
            raise ValueError(f"unknown optimizer {cfg.optimizer_type}")
        self.names: List[str] = []
        self.params: List[torch.Tensor] = []
        for name, p in named_params:
            self.names.append(name)
            self.params.append(p)
        self.kind = cfg.optimizer_type
        self.momentum = cfg.momentum
        self.schedule = build_lr_schedule(cfg, world_size)
        self.grad_clip_norm = grad_clip_norm
        self.ema_decay = cfg.moving_average_decay if cfg.use_moving_average else None
        self.count = 0  # updates made
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.state: Dict[str, List[torch.Tensor]] = {}
        if self.kind == "adam":
            self.state = {"mu": zeros(), "nu": zeros()}
        elif self.kind == "rmsprop":
            self.state = {"nu": zeros(), "trace": zeros()}
        elif self.kind == "momentum":
            self.state = {"trace": zeros()}
        self.ema: Optional[List[torch.Tensor]] = (
            [p.detach().clone() for p in self.params] if self.ema_decay is not None else None
        )

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax.clip_by_global_norm: unchanged below the limit, else
        (g / ||g||) * limit; the test stays on the device."""
        if not self.grad_clip_norm or self.grad_clip_norm <= 0:
            return grads
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        keep = norm < self.grad_clip_norm
        return [torch.where(keep, g, g / norm * self.grad_clip_norm) for g in grads]

    def updates(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The base optimizer's updates (to add to the parameters)."""
        lr = float(self.schedule(self.count))
        if self.kind == "adam":
            t = self.count + 1
            bc1 = float(np.float32(1) - np.power(np.float32(ADAM_B1), np.float32(t), dtype=np.float32))
            bc2 = float(np.float32(1) - np.power(np.float32(ADAM_B2), np.float32(t), dtype=np.float32))
            out = []
            for g, mu, nu in zip(grads, self.state["mu"], self.state["nu"]):
                mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
                nu.copy_((1 - ADAM_B2) * g.square() + ADAM_B2 * nu)
                out.append(-lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)))
            return out
        if self.kind == "sgd":
            return [-lr * g for g in grads]
        if self.kind == "momentum":
            out = []
            for g, tr in zip(grads, self.state["trace"]):
                tr.copy_(g + self.momentum * tr)
                out.append(-lr * tr)
            return out
        out = []  # rmsprop
        for g, nu, tr in zip(grads, self.state["nu"], self.state["trace"]):
            nu.copy_((1 - RMS_DECAY) * g.square() + RMS_DECAY * nu)
            tr.copy_(-lr * (g * torch.rsqrt(nu + RMS_EPS)) + self.momentum * tr)
            out.append(tr.clone())
        return out

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """One update of every parameter in place (and of the EMA)."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        with tracing.span("optimizer.clip"):
            grads = self.clip(list(grads))
        with tracing.span("optimizer.update"):
            for p, u in zip(self.params, self.updates(grads)):
                p.add_(u)
        if self.ema is not None:
            d = self.ema_decay
            with tracing.span("optimizer.ema"):
                for e, p in zip(self.ema, self.params):
                    e.copy_(d * e + (1.0 - d) * p)
        self.count += 1

    def ema_state_dict(self) -> Optional[Dict[str, torch.Tensor]]:
        """The averaged parameters by name (None without the EMA)."""
        return None if self.ema is None else dict(zip(self.names, self.ema))

    def state_dict(self) -> dict:
        out = {"count": self.count,
               "state": {k: dict(zip(self.names, v)) for k, v in self.state.items()}}
        if self.ema is not None:
            out["ema"] = self.ema_state_dict()
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Restore a `state_dict()` of an optimizer over the same names."""
        if set(sd["state"]) != set(self.state) or ("ema" in sd) != (self.ema is not None):
            raise ValueError("optimizer state of another kind")
        with torch.no_grad():
            for key, tensors in self.state.items():
                for name, t in zip(self.names, tensors):
                    t.copy_(sd["state"][key][name])
            if self.ema is not None:
                for name, t in zip(self.names, self.ema):
                    t.copy_(sd["ema"][name])
        self.count = int(sd["count"])


def build_optimizer(module: torch.nn.Module, cfg: OptimizerConfig, world_size: int = 1,
                    grad_clip_norm: float = 1.0) -> Optimizer:
    """The optimizer over every parameter of `module` (its BatchNorm
    statistics are buffers, outside it)."""
    return Optimizer(module.named_parameters(), cfg, world_size, grad_clip_norm)
