"""The ranks of the port's data-parallel tests, importing neither jax nor
the JAX package: each rank is a process started by `spawn`
(`heterofusionrcnn_torch.parallel.distributed.spawn_ranks`), which imports
the module of its function afresh, so these functions live apart from the
test files (tests/test_torch_parallel.py), whose JAX import would follow
them into every rank. `chip_smoke.py` runs `run_steps` on the card.

- `run_steps`: train steps of the RPN or the RCNN from given weights on
  global batches, each rank on its rows (also the one-process reference:
  no group, the whole batch);
- `steps_rank`: a rank of a gloo group on the CPU running `run_steps`,
  its results saved to `<out_dir>/rank<r>.pt`;
- `layers_rank`: a rank running the layer and loss cases of
  tests/test_torch_parallel.py (`layer_cases`) on its rows.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from heterofusionrcnn_torch.core.losses import bin_losses
from heterofusionrcnn_torch.experiments.common import make_rcnn_train_step
from heterofusionrcnn_torch.inference import CLUSTER_SIZES, exact_float32
from heterofusionrcnn_torch.models.extractors.layers import BatchNorm, BatchNorm2d, dropout
from heterofusionrcnn_torch.models.rcnn import RcnnModel, rcnn_loss
from heterofusionrcnn_torch.models.rpn import RpnModel, rpn_fts_channels, rpn_loss
from heterofusionrcnn_torch.parallel.distributed import initialize_distributed, shutdown_distributed
from heterofusionrcnn_torch.parallel.mesh import replicate_state, shard_batch
from heterofusionrcnn_torch.runtime.optimizer import build_optimizer
from heterofusionrcnn_torch.runtime.train_state import TrainState, make_rpn_train_step


def build(kind: str, cfg, group=None):
    """The train-mode model of `kind` ("rpn" or "rcnn") at `cfg`'s widths
    (3 classes, the inference mean sizes, the RCNN's thresholds from the
    mini-batch config) and its loss: this rank's share with a `group`."""
    mc = cfg.model_config
    if kind == "rpn":
        return RpnModel(mc, 3, CLUSTER_SIZES, mode="train"), lambda p: rpn_loss(p, mc, group)
    mb = cfg.dataset_config.mini_batch_config
    model = RcnnModel(mc, 3, CLUSTER_SIZES, rpn_fts_channels(mc), mode="train",
                      cls_neg_iou_hi=mb.cls_iou_3d_thresholds.neg_iou_hi,
                      cls_pos_iou_lo=mb.cls_iou_3d_thresholds.pos_iou_lo,
                      reg_pos_iou_lo=mb.reg_iou_3d_thresholds.pos_iou_lo)
    return model, lambda p: rcnn_loss(p, mc, group)


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def run_steps(spec: dict, group, device: str, make_step: Optional[Callable] = None) -> dict:
    """`spec`'s train steps: {"kind", "cfg", "state_dict" (the weights),
    "seed" (the generators), "batches" (global host batches: the keys the
    step reads)} on `device`, this rank's rows of each batch with a
    `group`, from rank 0's state (`replicate_state`). The optimizer takes
    world size 1 (the learning rate unscaled), so that W ranks and one
    process apply the same update; float32 stays float32 on the card (TF32
    off, as the trainer sets it). An optional spec["restarts"][i]
    ({"state_dict", "optimizer"}) replaces the module's and the optimizer's
    state before step i (the generators go on), so that each step can start
    from another run's state. `make_step` (loss_fn -> step) replaces the
    stage's step factory, e.g. to count launches.

    Returns {"steps": per step {"metrics": {name: float}, "state_dict",
    "optimizer"} after it, on the CPU, "step": the final step count}."""
    exact_float32()
    kind, cfg = spec["kind"], spec["cfg"]
    model, loss_fn = build(kind, cfg, group)
    model.load_state_dict(spec["state_dict"])
    model.to(device)
    tc = cfg.train_config
    opt = build_optimizer(model, tc.optimizer, 1, tc.grad_clip_norm)
    state = TrainState.create(model, opt, spec["seed"], group)
    replicate_state(state, group)
    make_step = make_step or (make_rpn_train_step if kind == "rpn" else make_rcnn_train_step)
    step = make_step(loss_fn)
    steps = []
    restarts = spec.get("restarts") or [None] * len(spec["batches"])
    for batch, restart in zip(spec["batches"], restarts):
        if restart is not None:
            model.load_state_dict(restart["state_dict"])
            opt.load_state_dict(restart["optimizer"])
        local = shard_batch({k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in batch.items()}, group)
        metrics = step(state, {k: v.to(device) for k, v in local.items()})
        steps.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                          state_dict=_cpu(model.state_dict()), optimizer=_cpu(opt.state_dict())))
    return {"steps": steps, "step": state.step}


def steps_rank(rank: int, world_size: int, init_method: str, spec_path: str,
               out_dir: str) -> None:
    """A rank of a gloo group on the CPU: `run_steps` of the spec saved at
    `spec_path`, its result saved to <out_dir>/rank<rank>.pt."""
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    group = initialize_distributed(rank, world_size, init_method, device="cpu")["group"]
    try:
        torch.save(run_steps(spec, group, "cpu"), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown_distributed()


def _rows(tree, group):
    """This rank's rows of every array of a dict / tuple tree, as tensors."""
    if isinstance(tree, dict):
        return {k: _rows(v, group) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_rows(v, group) for v in tree)
    return shard_batch({"rows": torch.as_tensor(tree)}, group)["rows"]


def layer_cases(inputs: Dict[str, dict], group) -> dict:
    """The layer and loss cases of tests/test_torch_parallel.py on this
    rank's rows of each case's global inputs (`inputs`: numpy arrays; no
    group: the whole batch):

      - "bn_last", "bn_nchw": a `BatchNorm` (channels last) or `BatchNorm2d`
        (NCHW) in training on rows of "x", its loss sum(out * "cot"): the
        output, the running statistics and the gradients of x, weight and
        bias; "bn_last_bf16", "bn_nchw_bf16": the same on "x" rounded to
        bf16 (a bf16 output and x gradient, float32 statistics);
      - "dropout": the kept mask of a rate-0.3 dropout of rows of ones of
        "shape", drawn from a generator seeded "seed", and that
        generator's next uniform; "dropout_bf16": the same on bf16 ones,
        with the output;
      - "loss_<case>": `bin_losses`, `rpn_loss` and `rcnn_loss` (their
        loss dicts' values) on rows of the case's "rpn" and "rcnn"
        predictions.
    """
    from heterofusionrcnn_torch.configs import presets

    out = {}
    for name, cls, dtype in (("bn_last", BatchNorm, torch.float32),
                             ("bn_nchw", BatchNorm2d, torch.float32),
                             ("bn_last_bf16", BatchNorm, torch.bfloat16),
                             ("bn_nchw_bf16", BatchNorm2d, torch.bfloat16)):
        case = inputs[name.removesuffix("_bf16")]
        bn = cls(len(case["weight"])).train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(case["weight"]))
            bn.bias.copy_(torch.from_numpy(case["bias"]))
        bn.dp_group = group
        x = _rows(case["x"], group).to(dtype).clone().requires_grad_(True)
        y = bn(x)
        (y.float() * _rows(case["cot"], group)).sum().backward()
        out[name] = dict(y=y, running_mean=bn.running_mean, running_var=bn.running_var,
                         x_grad=x.grad, weight_grad=bn.weight.grad, bias_grad=bn.bias.grad)

    case = inputs["dropout"]
    for name, dtype in (("dropout", torch.float32), ("dropout_bf16", torch.bfloat16)):
        gen = torch.Generator().manual_seed(case["seed"])
        x = _rows(np.ones(case["shape"], np.float32), group).to(dtype)
        y = dropout(x, 0.3, gen, group)
        out[name] = dict(mask=y != 0, next=torch.rand(1, generator=gen))
        if dtype != torch.float32:
            out[name]["y"] = y

    mc = presets.rpn_unittest().model_config
    for key, case in inputs.items():
        if key.startswith("loss_"):
            rpn, rcnn = _rows(case["rpn"], group), _rows(case["rcnn"], group)
            heads = (rpn["cls_preds"], rpn["cls_gts"], rpn["reg_preds"], rpn["reg_gts"])
            out[key] = dict(
                bin=torch.stack(bin_losses(*heads, rpn["foreground_mask"].float(),
                                           mc.loss_config, group)),
                rpn=torch.stack(list(rpn_loss(rpn, mc, group)[0].values())),
                rcnn=torch.stack(list(rcnn_loss(rcnn, mc, group)[0].values())))
    return _cpu(out)


def layers_rank(rank: int, world_size: int, init_method: str, inputs_path: str,
                out_dir: str) -> None:
    """A rank of a gloo group on the CPU: `layer_cases` of the inputs saved
    at `inputs_path`, saved to <out_dir>/rank<rank>.pt."""
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=False)
    group = initialize_distributed(rank, world_size, init_method, device="cpu")["group"]
    try:
        torch.save(layer_cases(inputs, group), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown_distributed()
