"""Train state and the train steps (PyTorch port of
heterofusionrcnn_tpu/runtime/train_state.py; the RCNN's step is
`experiments.common.make_rcnn_train_step`, as in the JAX package).

`TrainState` holds what the JAX package's `TrainState` pytree holds, as
live objects: the module (its parameters and BatchNorm statistics), the
optimizer (its moments and the parameter EMA), the step count, and the
generators of the random draws ("dropout" and "path_drop", the flax rng
streams) on the module's device. A step updates all of them in place.

Under data parallelism the state also holds the process group, and its
module the same group (`parallel/mesh.py`): each of the W ranks runs the
step on its rows of the global batch, differentiates its share of the
global loss (its sums over the global counts), and the ranks' gradients
are summed in one all-reduce before clipping and the optimizer, so every
rank applies the one-process step's update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from heterofusionrcnn_torch.parallel.mesh import all_reduce_flat, set_data_parallel_group
from heterofusionrcnn_torch.runtime import tracing
from heterofusionrcnn_torch.runtime.optimizer import Optimizer

RPN_BATCH_KEYS = (
    "point_cloud", "image_input", "stereo_calib_p2",
    "label_seg", "label_reg", "label_boxes_3d",
)


@dataclass
class TrainState:
    """Module + optimizer (with its EMA) + step + generators, and the
    data-parallel group (None: one process)."""

    model: nn.Module
    optimizer: Optimizer
    generators: Dict[str, torch.Generator]
    step: int = 0
    group: Optional[dist.ProcessGroup] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer, seed: int = 0,
               group: Optional[dist.ProcessGroup] = None) -> "TrainState":
        """The state at step 0, its generators on the model's device seeded
        seed + 1 ("dropout") and seed + 2 ("path_drop"), as the JAX trainer
        seeds those rng streams (the weights take `seed` itself); `group`
        is handed to the model's layers too."""
        device = next(model.parameters()).device
        generators = {name: torch.Generator(device=device).manual_seed(seed + i)
                      for i, name in ((1, "dropout"), (2, "path_drop"))}
        set_data_parallel_group(model, group)
        return cls(model, optimizer, generators, group=group)

    @property
    def ema(self) -> Optional[Dict[str, torch.Tensor]]:
        """The optimizer's parameter EMA by name (None when it keeps none)."""
        return self.optimizer.ema_state_dict()


def train_step(state: TrainState, forward: Callable, loss_fn: Callable):
    """One step of `state`: `forward(model, generators)` in train mode
    (BatchNorm statistics move), `loss_fn` on its predictions, the
    gradients, clipping, the optimizer update and the EMA, `state.step` + 1.
    Returns the predictions and the metrics: the loss dict and
    "total_loss", 0-d device tensors.

    With `state.group`, `loss_fn` gives this rank's share of the global
    loss; the gradients and the loss shares are summed over the ranks in
    one all-reduce of a flat buffer, so every rank gets the global
    gradient and the global metrics."""
    with tracing.span("train.step"):
        model = state.model
        model.train()
        params: List[torch.Tensor] = state.optimizer.params
        with torch.enable_grad():
            with tracing.span("train.forward"):
                preds = forward(model, state.generators)
            with tracing.span("train.loss"):
                loss_dict, total = loss_fn(preds)
            with tracing.span("train.backward"):
                grads = torch.autograd.grad(total, params)
        names = list(loss_dict)
        values = [loss_dict[k].detach() for k in names] + [total.detach()]
        if state.group is not None:
            with tracing.span("train.all_reduce"):
                summed = all_reduce_flat([*grads, *values], state.group)
            grads, values = summed[:len(grads)], summed[len(grads):]
        with tracing.span("train.optimizer"):
            state.optimizer.step(grads)
        state.step += 1
    metrics = dict(zip(names, values))
    metrics["total_loss"] = values[-1]
    return preds, metrics


def make_rpn_train_step(loss_fn: Callable) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                                       Dict[str, torch.Tensor]]:
    """The RPN train step.

    Args:
      loss_fn: predictions -> (loss_dict, total).
    Returns:
      train_step(state, batch) -> metrics (`train_step` above, plus
      "seg_accuracy"); `batch` holds `RPN_BATCH_KEYS` as tensors on the
      model's device.
    """

    def rpn_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        preds, metrics = train_step(
            state, lambda model, gens: model(*(batch.get(k) for k in RPN_BATCH_KEYS),
                                             generators=gens), loss_fn)
        metrics["seg_accuracy"] = preds["seg_accuracy"].detach()
        return metrics

    return rpn_step
