"""The data-parallel group and what the JAX package gets from its sharding
annotations (PyTorch port of heterofusionrcnn_tpu/parallel/mesh.py).

The JAX package trains data-parallel as one `jit` over a batch sharded on a
1-axis mesh, so its arithmetic is that of the whole global batch: BatchNorm
statistics, loss counts and dropout masks are global, and XLA sums the
gradient. Here each of W ranks is a process of a `torch.distributed`
group holding rows [r * b, (r + 1) * b) of the global batch (b = B / W),
and the same arithmetic comes from explicit collectives:

  - `all_reduce_sum`, differentiable: BatchNorm's sums and E[x^2], the
    losses' counts (`models/extractors/layers.py`, `core/losses.py`);
  - `all_reduce_flat`: the gradients (and the step's loss shares) in one
    all-reduce over a flat buffer (`runtime/train_state.py`);
  - `replicate_state`: Horovod's rank-0 broadcast of the whole train state.

The group is held explicitly: the layers that need it carry it in their
`dp_group` attribute (`set_data_parallel_group`, as `nn.SyncBatchNorm`
carries `process_group`), the loss functions and `TrainState` take it as
an argument. None everywhere means one process, and then every function
computes exactly what it computes without this module.

The reference's knobs map as in the JAX package:
  hvd.size()                  -> the group's world size
  hvd.DistributedOptimizer    -> `all_reduce_flat` of the gradients
  BroadcastGlobalVariables(0) -> `replicate_state`
  lr * hvd.size()             -> lr * world size (`runtime/optimizer.py`)
  iterations / hvd.size()     -> iterations / world size (`runtime/trainer.py`)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn


def rank_and_size(group: Optional[dist.ProcessGroup]) -> Tuple[int, int]:
    """(rank, world size) in `group`; (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def rows_per_rank(global_batch: int, group: Optional[dist.ProcessGroup]) -> int:
    """The rows of a global batch each rank holds; raises ValueError where
    the world size does not divide the batch (as JAX's
    `NamedSharding(P("data"))` requires)."""
    _, world = rank_and_size(group)
    if global_batch % world:
        raise ValueError(f"a global batch of {global_batch} does not split over {world} ranks")
    return global_batch // world


def shard_batch(batch: Dict[str, torch.Tensor],
                group: Optional[dist.ProcessGroup]) -> Dict[str, torch.Tensor]:
    """This rank's rows [r * b, (r + 1) * b) of every entry of a global
    batch (leading axis: the frames)."""
    rank, _ = rank_and_size(group)
    out = {}
    for key, val in batch.items():
        b = rows_per_rank(val.shape[0], group)
        out[key] = val[rank * b:(rank + 1) * b]
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the incoming gradients over
    the group too (every rank's loss depends on every rank's input through
    the sum), as `nn.SyncBatchNorm`'s backward does."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum of `x` over the ranks of `group` (differentiable); `x`
    itself without a group."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_flat(tensors: Sequence[torch.Tensor],
                    group: Optional[dist.ProcessGroup]) -> List[torch.Tensor]:
    """Each tensor summed over the group, in one all-reduce over a flat
    buffer of them all (one dtype and device); the tensors themselves
    without a group."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [piece.view_as(t) for piece, t in zip(flat.split([t.numel() for t in tensors]),
                                                  tensors)]


def any_rank(flag: bool, group: Optional[dist.ProcessGroup], device) -> bool:
    """True on every rank where `flag` holds on any rank."""
    if group is None:
        return bool(flag)
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def _broadcast_from_rank0(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup) -> None:
    """Rank 0's values into `tensors` on every rank, one broadcast per
    dtype over a flat buffer."""
    src = dist.get_global_rank(group, 0)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        for t, piece in zip(ts, flat.split([t.numel() for t in ts])):
            t.detach().copy_(piece.view_as(t))


@torch.no_grad()
def replicate_state(state, group: Optional[dist.ProcessGroup]):
    """Rank 0's train state on every rank (Horovod's
    `BroadcastGlobalVariables(0)`): the module's parameters and buffers,
    the optimizer's moments and EMA, its update count, the step and the
    generators' states. Returns `state`, changed in place; unchanged
    without a group."""
    if group is None:
        return state
    model, opt = state.model, state.optimizer
    device = next(model.parameters()).device
    tensors = [*model.parameters(), *model.buffers()]
    tensors += [t for ts in opt.state.values() for t in ts] + list(opt.ema or [])
    _broadcast_from_rank0(tensors, group)
    names = sorted(state.generators)
    counters = torch.tensor([state.step, opt.count], dtype=torch.int64, device=device)
    gen_states = [state.generators[n].get_state().to(device) for n in names]
    _broadcast_from_rank0([counters, *gen_states], group)
    state.step, opt.count = (int(v) for v in counters.tolist())
    for n, s in zip(names, gen_states):
        state.generators[n].set_state(s.cpu())
    return state


def set_data_parallel_group(module: nn.Module, group: Optional[dist.ProcessGroup]) -> nn.Module:
    """Hands `group` to every submodule that takes one (those with a
    `dp_group` attribute: the BatchNorms, and the models and extractors
    that draw dropout masks)."""
    for m in module.modules():
        if hasattr(m, "dp_group"):
            m.dp_group = group
    return module
