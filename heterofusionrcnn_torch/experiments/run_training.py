"""Training CLI (PyTorch port of heterofusionrcnn_tpu/experiments/
run_training.py, either stage on one device). Runs on the card unless
given `--device cpu`.

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
`run_inference` reads their module weights. Data parallelism
(`--num_devices` above 1) is not ported yet and raises.
"""

from __future__ import annotations

import argparse

import torch

from heterofusionrcnn_torch.experiments import common
from heterofusionrcnn_torch.experiments.common import make_rcnn_train_step
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
from heterofusionrcnn_torch.runtime.train_state import make_rpn_train_step
from heterofusionrcnn_torch.runtime.trainer import train


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train the RPN with the PyTorch/CUDA port")
    parser.add_argument("--pipeline_config", required=True,
                        help="preset name or JSON config path")
    parser.add_argument("--data_split", default=None)
    parser.add_argument("--dataset_dir", default=None)
    parser.add_argument("--output_root", default="outputs")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="data-parallel world size; only 1 is ported")
    parser.add_argument("--max_iterations", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_steps", default=None,
                        help="START:STOP step range traced with torch.profiler "
                             "into <logs>/profile")
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


def main(argv=None):
    """Run the CLI; returns the final TrainState."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available")
    if args.num_devices not in (None, 1):
        raise NotImplementedError(
            f"--num_devices {args.num_devices}: data-parallel training is not ported yet "
            "(ROADMAP Queue 1, item 6)")

    cfg = common.resolve_config(args.pipeline_config, args.dataset_dir)
    if args.max_iterations:
        cfg.train_config.max_iterations = args.max_iterations

    model_kind = "rpn" if cfg.model_config.model_name == "rpn_model" else "rcnn"
    dataset = common.build_dataset(cfg, "train", args.data_split)
    dataset.seed(args.seed)
    if model_kind == "rcnn":
        handoff = (args.proposal_dir, args.proposal_iou_dir, args.rpn_feature_dir)
        if None in handoff:
            raise ValueError(
                "training the RCNN needs the RPN's handoff files: pass --proposal_dir, "
                "--proposal_iou_dir and --rpn_feature_dir (run_evaluation "
                "--save_rpn_feature --for_rcnn_train writes them)")
        dataset.proposal_dir, dataset.proposal_iou_dir, dataset.rpn_feature_dir = handoff
    model, loss_fn = common.build_model(cfg, dataset, "train")
    next_batch = common.make_batch_fn(cfg, dataset, model_kind, cfg.train_config.batch_size)

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
    )


if __name__ == "__main__":
    main()
