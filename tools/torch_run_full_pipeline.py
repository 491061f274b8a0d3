"""One-command two-stage pipeline of the PyTorch port (counterpart of
tools/run_full_pipeline.py): RPN training -> the RPN's evaluation on the
train and eval splits (the handoff files) -> RCNN training from the handoff,
warm-started from the RPN -> the RCNN's evaluation with KITTI AP.

    python tools/torch_run_full_pipeline.py --rpn_config rpn_multiclass \
        --rcnn_config rcnn_multiclass --dataset_dir /data/Kitti/object \
        --output_root outputs

Each stage is one of the port's CLIs (`experiments.run_training`,
`experiments.run_evaluation`) with the flags this tool passes on, so each
stays resumable from its own checkpoints and files, and the four commands
it prints can be run by hand. The handoff evaluation uses the RPN's train
NMS sizes (`--for_rcnn_train`), and the RCNN trains with seed + 1. Runs on
the card unless given `--device cpu`.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

from heterofusionrcnn_torch.experiments import common, run_evaluation, run_training
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rpn_config", default="rpn_multiclass")
    parser.add_argument("--rcnn_config", default="rcnn_multiclass")
    parser.add_argument("--dataset_dir", default=None)
    parser.add_argument("--output_root", default="outputs")
    parser.add_argument("--train_split", default="train")
    parser.add_argument("--eval_split", default="val")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="data-parallel ranks of both trainings (run_training's)")
    parser.add_argument("--rpn_iterations", type=int, default=None)
    parser.add_argument("--rcnn_iterations", type=int, default=None)
    parser.add_argument("--num_rois", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def handoff_dirs(output_root: str, rpn_name: str, split: str, step: int):
    """The RPN evaluator's three handoff directories of `split` at `step`."""
    base = os.path.join(output_root, rpn_name, "predictions")
    return [os.path.join(base, kind, split, str(step))
            for kind in ("proposals_and_scores", "proposals_iou", "rpn_feature")]


def handoff_flags(dirs):
    return ["--proposal_dir", dirs[0], "--proposal_iou_dir", dirs[1], "--rpn_feature_dir", dirs[2]]


def main(argv=None) -> dict:
    """Runs the four stages; returns {"rpn_step", "rcnn_step", "recall"
    (split -> (recall@0.5, recall@0.7)), "ap", "stage_s" (seconds a stage)}."""
    args = parse_args(argv)
    common_flags = ["--output_root", args.output_root, "--device", args.device]
    if args.dataset_dir:
        common_flags += ["--dataset_dir", args.dataset_dir]
    train_flags = [] if args.num_devices is None else ["--num_devices", str(args.num_devices)]
    rpn_name = common.resolve_config(args.rpn_config).model_config.checkpoint_name
    rpn_ckpts = os.path.join(args.output_root, rpn_name, "checkpoints")
    out = {"stage_s": {}, "recall": {}}

    def stage(name, fn):
        t0 = time.perf_counter()
        result = fn()
        out["stage_s"][name] = time.perf_counter() - t0
        print(f"[pipeline] stage {name}: {out['stage_s'][name]:.1f} s", flush=True)
        return result

    # Stage 1: RPN training.
    rpn_iters = ["--max_iterations", str(args.rpn_iterations)] if args.rpn_iterations else []
    stage("rpn_train", lambda: run_training.main([
        "--pipeline_config", args.rpn_config, "--data_split", args.train_split,
        "--seed", str(args.seed), *rpn_iters, *train_flags, *common_flags]))
    rpn_step = CheckpointManager(rpn_ckpts).latest_step()
    print(f"[pipeline] RPN trained to step {rpn_step}", flush=True)

    # Stage 2: the RPN on both splits with the train NMS sizes: the handoff.
    def handoff():
        for split in dict.fromkeys([args.train_split, args.eval_split]):
            summary, = run_evaluation.main([
                "--pipeline_config", args.rpn_config, "--data_split", split,
                "--ckpt_indices", str(rpn_step), "--save_rpn_feature", "--for_rcnn_train",
                *common_flags])
            out["recall"][split] = (summary["recall_50"], summary["recall_70"])
            print(f"[pipeline] RPN eval on {split}: recall@0.5={summary['recall_50']:.3f} "
                  f"recall@0.7={summary['recall_70']:.3f}", flush=True)

    stage("rpn_handoff", handoff)

    # Stage 3: RCNN training from the train split's handoff, warm-started
    # from the RPN's latest checkpoint.
    rcnn_iters = ["--max_iterations", str(args.rcnn_iterations)] if args.rcnn_iterations else []
    stage("rcnn_train", lambda: run_training.main([
        "--pipeline_config", args.rcnn_config, "--data_split", args.train_split,
        "--seed", str(args.seed + 1), "--warm_start_from", rpn_ckpts,
        *handoff_flags(handoff_dirs(args.output_root, rpn_name, args.train_split, rpn_step)),
        *rcnn_iters, *train_flags, *common_flags]))
    rcnn_name = common.resolve_config(args.rcnn_config).model_config.checkpoint_name
    rcnn_step = CheckpointManager(
        os.path.join(args.output_root, rcnn_name, "checkpoints")).latest_step()
    print(f"[pipeline] RCNN trained to step {rcnn_step}", flush=True)

    # Stage 4: the RCNN on the eval split's handoff, with AP.
    summary, = stage("rcnn_eval", lambda: run_evaluation.main([
        "--pipeline_config", args.rcnn_config, "--data_split", args.eval_split,
        "--ckpt_indices", str(rcnn_step), "--num_rois", str(args.num_rois),
        *handoff_flags(handoff_dirs(args.output_root, rpn_name, args.eval_split, rpn_step)),
        *common_flags]))
    out.update(rpn_step=rpn_step, rcnn_step=rcnn_step, ap=summary.get("ap", {}))
    print(f"[pipeline] done; AP: {out['ap']}", flush=True)
    return out


if __name__ == "__main__":
    main()
