"""The optimizer of the port (`runtime/optimizer.py`) as the configurations
use it: global-norm clipping, then Adam over an exponential-decay learning
rate, one process.

  - clip: g * max / ||g|| where the global norm ||g|| is at least `max`
    (optax's form, no epsilon);
  - the learning rate at the count of updates made before this one;
  - Adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
    correction at the count after this update.

BatchNorm statistics are buffers and are not optimised.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

from hfbench.reference.config import OptimizerConfig

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def learning_rate(cfg: OptimizerConfig, count: int) -> np.float32:
    """The initial rate, decayed by `decay_factor` every `decay_steps`
    (continuously unless staircase)."""
    init = np.float32(cfg.initial_learning_rate)
    if cfg.decay_steps <= 0 or cfg.decay_factor == 0 or count <= 0:
        return init
    p = np.float32(count) / np.float32(cfg.decay_steps)
    if cfg.staircase:
        p = np.floor(p)
    return init * np.power(np.float32(cfg.decay_factor), p, dtype=np.float32)


class Optimizer:
    """Clip -> Adam over `named_params`, updated in place by `step(grads)`."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], cfg: OptimizerConfig,
                 grad_clip_norm: float = 1.0):
        if cfg.optimizer_type != "adam" or cfg.use_moving_average:
            raise NotImplementedError("the reference follows Adam without a parameter EMA")
        self.cfg = cfg
        self.names: List[str] = []
        self.params: List[torch.Tensor] = []
        for name, p in named_params:
            self.names.append(name)
            self.params.append(p)
        self.grad_clip_norm = grad_clip_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if not self.grad_clip_norm or self.grad_clip_norm <= 0:
            return grads
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        keep = norm < self.grad_clip_norm
        return [torch.where(keep, g, g / norm * self.grad_clip_norm) for g in grads]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        lr = float(learning_rate(self.cfg, self.count))
        t = self.count + 1
        bc1 = float(np.float32(1) - np.power(np.float32(ADAM_B1), np.float32(t), dtype=np.float32))
        bc2 = float(np.float32(1) - np.power(np.float32(ADAM_B2), np.float32(t), dtype=np.float32))
        for p, g, mu, nu in zip(self.params, self.clip(list(grads)), self.mu, self.nu):
            mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
            nu.copy_((1 - ADAM_B2) * g.square() + ADAM_B2 * nu)
            p.add_(-lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)))
        self.count += 1


def build_optimizer(module: torch.nn.Module, cfg: OptimizerConfig,
                    grad_clip_norm: float = 1.0) -> Optimizer:
    return Optimizer(module.named_parameters(), cfg, grad_clip_norm)
