"""Convert a JAX training checkpoint (orbax, written by
heterofusionrcnn_tpu.runtime.checkpoint.CheckpointManager) into the PyTorch
port's checkpoint, so that the port's `run_inference`, `run_evaluation`
and `run_training` take over a run trained with JAX.

    python tools/convert_orbax_checkpoint.py --pipeline_config rpn_multiclass \
        --orbax_dir outputs/rpn_multiclass/checkpoints \
        --out_dir torch_outputs/rpn_multiclass/checkpoints [--step N]

Reads step N (default: the latest) and writes <out_dir>/<N>/checkpoint.pt
through the port's CheckpointManager:

- the weights: `params` and `batch_stats` through
  `heterofusionrcnn_torch.convert.flax_to_state_dict`, with each
  BatchNorm's `num_batches_tracked` (0) so that the state dict loads whole;
- the port's `Optimizer.state_dict()` of the optimizer state: the
  moments by parameter name (Adam `mu` / `nu`, momentum `trace`, RMSProp
  `nu` / `trace`), each through the same layout change as its parameter (a Dense kernel's transposed, a Conv's HWIO ->
  OIHW, a ConvTranspose's flipped and permuted); `count`, the updates made
  (optax's Adam count, or its schedule count); and with the config's
  `use_moving_average` the parameter EMA, converted as the weights.

The optax chain's state is restored with a template built from the same
pipeline config (the optimizer of `train_config`), as the JAX trainer
restores it: an untyped restore would lose the chain's state types. This
is the one script of the repo that imports both packages; it runs where
JAX is installed, and its output is read wherever the port runs.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import optax
import torch

from heterofusionrcnn_tpu.experiments import common as jax_common
from heterofusionrcnn_tpu.runtime.checkpoint import CheckpointManager as OrbaxManager
from heterofusionrcnn_tpu.runtime.optimizer import ParamEmaState, build_optimizer
from heterofusionrcnn_tpu.runtime.train_state import TrainState

from heterofusionrcnn_torch.convert import flax_to_state_dict
from heterofusionrcnn_torch.experiments import common
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
from heterofusionrcnn_torch.runtime.optimizer import Optimizer


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--pipeline_config", required=True,
                        help="preset name or JSON config path of the JAX run")
    parser.add_argument("--orbax_dir", required=True, help="the JAX run's checkpoints directory")
    parser.add_argument("--out_dir", required=True, help="the port's checkpoints directory")
    parser.add_argument("--step", type=int, default=None, help="default: the latest")
    return parser.parse_args(argv)


def restore_jax_state(orbax_dir: str, tx: optax.GradientTransformation, step=None):
    """The JAX TrainState of `step` (default: the latest), its optimizer
    state restored into the types of `tx.init` (no apply function)."""
    mgr = OrbaxManager(orbax_dir)
    try:
        step = mgr.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {orbax_dir}")
        raw = mgr.restore_raw(step)
        template = TrainState(step=jnp.zeros((), jnp.int32), params=raw["params"],
                              batch_stats=raw["batch_stats"], opt_state=tx.init(raw["params"]),
                              tx=tx, apply_fn=None)
        return mgr.restore(template, step)
    finally:
        mgr.close()


def module_state_dict(params, batch_stats) -> dict:
    """The port module's state dict: the converted weights, and 0 as every
    BatchNorm's `num_batches_tracked`."""
    sd = flax_to_state_dict(params, batch_stats)
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def optimizer_state_dict(opt_state) -> dict:
    """The port's `Optimizer.state_dict()` of an optax chain state built by
    `heterofusionrcnn_tpu.runtime.optimizer.build_optimizer` (the port's
    `Optimizer.load_state_dict` checks its kind and EMA against the
    config's)."""
    parts = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, tuple) and hasattr(x, "_fields"))
    by_type = {type(p): p for p in parts}
    convert = lambda tree: flax_to_state_dict(jax.device_get(tree))  # noqa: E731
    state, counts = {}, []
    adam = by_type.get(optax.ScaleByAdamState)
    if adam is not None:
        state = {"mu": convert(adam.mu), "nu": convert(adam.nu)}
        counts.append(int(adam.count))
    if optax.ScaleByRmsState in by_type:
        state["nu"] = convert(by_type[optax.ScaleByRmsState].nu)
    if optax.TraceState in by_type:
        state["trace"] = convert(by_type[optax.TraceState].trace)
    if optax.ScaleByScheduleState in by_type:
        counts.append(int(by_type[optax.ScaleByScheduleState].count))
    if not counts or len(set(counts)) != 1:
        raise ValueError(f"optimizer state with update counts {counts}")
    out = {"count": counts[0], "state": state}
    if ParamEmaState in by_type:
        out["ema"] = convert(by_type[ParamEmaState].ema)
    return out


def main(argv=None) -> str:
    """Converts one checkpoint; returns the written file's path."""
    args = parse_args(argv)
    jtc = jax_common.resolve_config(args.pipeline_config).train_config
    tc = common.resolve_config(args.pipeline_config).train_config
    tx = build_optimizer(jtc.optimizer, grad_clip_norm=jtc.grad_clip_norm)
    state = restore_jax_state(args.orbax_dir, tx, args.step)
    step = int(state.step)
    params = jax.device_get(state.params)
    sd = module_state_dict(params, jax.device_get(state.batch_stats))
    # The port's optimizer over the converted parameters takes the
    # converted state: its load checks the names, the kind and the EMA.
    opt = Optimizer(((n, sd[n].clone()) for n in flax_to_state_dict(params)), tc.optimizer,
                    grad_clip_norm=tc.grad_clip_norm)
    opt.load_state_dict(optimizer_state_dict(state.opt_state))
    CheckpointManager(args.out_dir).save(step, SimpleNamespace(model=sd, optimizer=opt))
    path = os.path.join(os.path.abspath(args.out_dir), str(step), "checkpoint.pt")
    print(f"step {step}: {len(sd)} tensors, optimizer count {opt.count} -> {path}", flush=True)
    return path


if __name__ == "__main__":
    main()
