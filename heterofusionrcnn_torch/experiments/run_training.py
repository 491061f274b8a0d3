"""Training CLI (PyTorch port of heterofusionrcnn_tpu/experiments/
run_training.py, either stage, one process or data-parallel). Runs on the
card unless given `--device cpu`.

    python -m heterofusionrcnn_torch.experiments.run_training \\
        --pipeline_config rpn_multiclass --data_split train \\
        --dataset_dir /path/to/Kitti/object --output_root outputs

The RCNN trains from the RPN evaluator's handoff files
(`run_evaluation --save_rpn_feature --for_rcnn_train` on the train split),
warm-started from the RPN's checkpoint:

    python -m heterofusionrcnn_torch.experiments.run_training \\
        --pipeline_config rcnn_multiclass --data_split train \\
        --warm_start_from outputs/rpn_multiclass/checkpoints \\
        --proposal_dir outputs/rpn_multiclass/predictions/proposals_and_scores/train/STEP \\
        --proposal_iou_dir outputs/rpn_multiclass/predictions/proposals_iou/train/STEP \\
        --rpn_feature_dir outputs/rpn_multiclass/predictions/rpn_feature/train/STEP

Checkpoints (module, optimizer, EMA, step) land in
<output_root>/<checkpoint_name>/checkpoints and resume from the latest;
`run_inference` reads their module weights.

Data parallelism, as JAX's `--num_devices`: N ranks, one process each
(NCCL, one card a rank; gloo with `--device cpu`), train on the config's
`batch_size` as one global batch, each rank on batch_size / N rows of it
loaded from its own shard of the samples; the learning rate is scaled by N
and the iteration budget divided by N. `--num_devices N` (default: every
visible card, 1 on the CPU) starts the N ranks itself; a command started
by `torchrun --nproc_per_node N` joins torchrun's group instead (N, if
given, must equal its WORLD_SIZE).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
from torch.multiprocessing import ProcessExitedException

from heterofusionrcnn_torch.experiments import common
from heterofusionrcnn_torch.experiments.common import make_rcnn_train_step
from heterofusionrcnn_torch.parallel.distributed import (
    initialize_distributed,
    shard_dataset_for_host,
    shutdown_distributed,
    spawn_ranks,
)
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
from heterofusionrcnn_torch.runtime.train_state import make_rpn_train_step
from heterofusionrcnn_torch.runtime.trainer import train

# The exit code of a rank that checkpointed for a relaunch (the trainer's
# HFR_MAX_HOST_RSS_MB cap).
RELAUNCH_EXIT = 75


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train the RPN with the PyTorch/CUDA port")
    parser.add_argument("--pipeline_config", required=True,
                        help="preset name or JSON config path")
    parser.add_argument("--data_split", default=None)
    parser.add_argument("--dataset_dir", default=None)
    parser.add_argument("--output_root", default="outputs")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="data-parallel ranks (default: every visible card; 1 on the CPU)")
    parser.add_argument("--max_iterations", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_steps", default=None,
                        help="START:STOP step range traced with torch.profiler into "
                             "<logs>/profile (a Chrome trace: the port's hfr.* ranges, "
                             "hfr.train.step around hfr.train.forward, .loss, .backward "
                             "and .optimizer, and the models' hfr.rpn.* / hfr.rcnn.*, on "
                             "the host thread's row around the operators and the launches "
                             "of the kernels on the device rows; runtime/tracing.py)")
    parser.add_argument("--warm_start_from", default=None,
                        help="checkpoint dir for partial weight transfer "
                             "(same-named, same-shaped tensors; e.g. RPN -> RCNN)")
    parser.add_argument("--proposal_dir", default=None,
                        help="RCNN only: dir of saved RPN proposals")
    parser.add_argument("--proposal_iou_dir", default=None,
                        help="RCNN only: dir of the proposals' 3D-IoU tables")
    parser.add_argument("--rpn_feature_dir", default=None,
                        help="RCNN only: dir of the RPN's per-point feature files")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def _config(args):
    """The pipeline config of `args` and the stage it trains ("rpn" or
    "rcnn"); raises for an RCNN without its handoff directories."""
    cfg = common.resolve_config(args.pipeline_config, args.dataset_dir)
    if args.max_iterations:
        cfg.train_config.max_iterations = args.max_iterations
    model_kind = "rpn" if cfg.model_config.model_name == "rpn_model" else "rcnn"
    if model_kind == "rcnn" and None in (args.proposal_dir, args.proposal_iou_dir,
                                         args.rpn_feature_dir):
        raise ValueError(
            "training the RCNN needs the RPN's handoff files: pass --proposal_dir, "
            "--proposal_iou_dir and --rpn_feature_dir (run_evaluation "
            "--save_rpn_feature --for_rcnn_train writes them)")
    return cfg, model_kind


def _world_size(args, cfg, torchrun: bool) -> int:
    """The number of ranks; raises ValueError for one that the global batch
    or, where this command starts the ranks, the visible cards cannot take."""
    if torchrun:
        world = int(os.environ["WORLD_SIZE"])
        if args.num_devices not in (None, world):
            raise ValueError(f"--num_devices {args.num_devices}, but torchrun started "
                             f"{world} ranks")
    elif args.num_devices is not None:
        world = args.num_devices
    else:
        world = torch.cuda.device_count() if args.device == "cuda" else 1
    if world < 1:
        raise ValueError(f"--num_devices {world}: at least one rank")
    if cfg.train_config.batch_size % world:
        raise ValueError(f"--num_devices {world} does not divide the global batch of "
                         f"{cfg.train_config.batch_size}")
    if args.device == "cuda" and not torchrun and world > torch.cuda.device_count():
        raise ValueError(f"--num_devices {world} on {torch.cuda.device_count()} visible "
                         "card(s): NCCL takes one card a rank")
    return world


def main(argv=None):
    """Run the CLI; returns the final TrainState (None where it started
    N > 1 ranks: rank 0 wrote the checkpoints and metrics). Exits 75 where
    the ranks checkpointed for a relaunch."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available")
    cfg, model_kind = _config(args)
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    world = _world_size(args, cfg, torchrun)
    if torchrun:
        info = initialize_distributed(device=args.device)
        try:
            return _train(args, cfg, model_kind, info["group"])
        finally:
            shutdown_distributed()
    if world > 1:
        try:
            spawn_ranks(_rank_main, world, args=(sys.argv[1:] if argv is None else list(argv),))
        except ProcessExitedException as exc:
            if exc.exit_code == RELAUNCH_EXIT:
                raise SystemExit(RELAUNCH_EXIT) from exc
            raise
        return None
    return _train(args, cfg, model_kind, None)


def _rank_main(rank: int, world_size: int, init_method: str, argv) -> None:
    """One rank of a run that `main` started (a spawned process)."""
    args = parse_args(argv)
    cfg, model_kind = _config(args)
    info = initialize_distributed(rank, world_size, init_method, device=args.device)
    try:
        _train(args, cfg, model_kind, info["group"])
    finally:
        shutdown_distributed()


def _train(args, cfg, model_kind: str, group):
    """Dataset (this rank's shard), model, loss and batches, then `train`."""
    dataset = common.build_dataset(cfg, "train", args.data_split)
    shard_dataset_for_host(dataset, group)
    dataset.seed(args.seed)
    if model_kind == "rcnn":
        dataset.proposal_dir = args.proposal_dir
        dataset.proposal_iou_dir = args.proposal_iou_dir
        dataset.rpn_feature_dir = args.rpn_feature_dir
    model, loss_fn = common.build_model(cfg, dataset, "train", group=group)
    next_batch = common.make_batch_fn(cfg, dataset, model_kind, cfg.train_config.batch_size,
                                      group)

    init_params_from = None
    if args.warm_start_from:
        init_params_from = CheckpointManager(args.warm_start_from).restore_raw()["state_dict"]

    profile_steps = None
    if args.profile_steps:
        a, b = args.profile_steps.split(":")
        profile_steps = (int(a), int(b))

    return train(
        model=model,
        loss_fn=loss_fn,
        make_train_step=make_rpn_train_step if model_kind == "rpn" else make_rcnn_train_step,
        next_batch=next_batch,
        pipeline_cfg=cfg,
        output_root=args.output_root,
        device=args.device,
        seed=args.seed,
        init_params_from=init_params_from,
        profile_steps=profile_steps,
        group=group,
    )


if __name__ == "__main__":
    main()
