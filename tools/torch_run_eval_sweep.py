"""Checkpoint AP sweep of the PyTorch port (counterpart of
tools/run_eval_sweep.py): evaluates every checkpoint of an RCNN run that
its ledger (logs/rcnn_eval.csv) does not list yet, each once, with its
ap_summary.json, then prints the best of them by car 3D AP moderate.

    python tools/torch_run_eval_sweep.py --pipeline_config rcnn_multiclass \
        --output_root outputs --proposal_dir ... --proposal_iou_dir ... \
        --rpn_feature_dir ...

The evaluations are `experiments.run_evaluation` over the steps to do.
Runs on the card unless given `--device cpu`.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

from heterofusionrcnn_torch.experiments import common, run_evaluation
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
from heterofusionrcnn_torch.runtime.evaluator import evaluated_steps


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--pipeline_config", required=True)
    parser.add_argument("--data_split", default="val")
    parser.add_argument("--dataset_dir", default=None)
    parser.add_argument("--output_root", default="outputs")
    parser.add_argument("--proposal_dir", required=True)
    parser.add_argument("--proposal_iou_dir", required=True)
    parser.add_argument("--rpn_feature_dir", required=True)
    parser.add_argument("--num_rois", type=int, default=100)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def main(argv=None):
    """Returns [(step, car 3D AP moderate)] of the steps evaluated, best first."""
    args = parse_args(argv)
    name = common.resolve_config(args.pipeline_config).model_config.checkpoint_name
    base = os.path.join(args.output_root, name)
    done = evaluated_steps(os.path.join(base, "logs"), "rcnn_eval.csv")
    todo = [s for s in CheckpointManager(os.path.join(base, "checkpoints")).all_steps()
            if s not in done]
    best = []
    if todo:
        flags = ["--pipeline_config", args.pipeline_config, "--data_split", args.data_split,
                 "--output_root", args.output_root, "--num_rois", str(args.num_rois),
                 "--proposal_dir", args.proposal_dir, "--proposal_iou_dir", args.proposal_iou_dir,
                 "--rpn_feature_dir", args.rpn_feature_dir, "--device", args.device,
                 "--ckpt_indices", *map(str, todo)]
        if args.dataset_dir:
            flags += ["--dataset_dir", args.dataset_dir]
        for summary in run_evaluation.main(flags):
            ap = summary.get("ap", {}).get("car_detection_3d", (0, 0, 0))[1]
            best.append((summary["global_step"], ap))
            print(f"step {summary['global_step']}: car 3D AP moderate = {ap:.2f}")
    best.sort(key=lambda kv: -kv[1])
    print("top checkpoints (car 3D AP moderate):")
    for step, ap in best[:5]:
        print(f"  step {step}: {ap:.2f}")
    return best


if __name__ == "__main__":
    main()
