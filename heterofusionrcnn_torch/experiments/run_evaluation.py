"""Evaluation CLI (PyTorch port of heterofusionrcnn_tpu/experiments/
run_evaluation.py), either stage. Runs on the card unless given
`--device cpu`.

    python -m heterofusionrcnn_torch.experiments.run_evaluation \\
        --pipeline_config rpn_multiclass --data_split train \\
        --save_rpn_feature --for_rcnn_train --output_root outputs

    python -m heterofusionrcnn_torch.experiments.run_evaluation \\
        --pipeline_config rcnn_multiclass --data_split val --num_rois 100 \\
        --proposal_dir outputs/rpn_multiclass/predictions/proposals_and_scores/val/STEP \\
        --proposal_iou_dir outputs/rpn_multiclass/predictions/proposals_iou/val/STEP \\
        --rpn_feature_dir outputs/rpn_multiclass/predictions/rpn_feature/val/STEP

Evaluates the checkpoints `--ckpt_indices` (default: the latest) of
<output_root>/<checkpoint_name>/checkpoints, without augmentation or path
drop; with `--evaluate_repeatedly` it watches that directory and evaluates
each new checkpoint once (`runtime.evaluator.repeated_checkpoint_run`).
The RPN (`runtime.evaluator.RpnEvaluator`): `--save_rpn_feature` writes
the per-point feature files of the RPN -> RCNN handoff; `--for_rcnn_train`
switches the RPN's NMS to the train sizes (512 proposals), so the saved
proposals feed RCNN training (reference run_evaluation.py:149-162). The
RCNN (`runtime.evaluator.RcnnEvaluator`) reads the RPN evaluator's files of
the same split from the three handoff directories, which it requires, its
proposals padded or cut to `--num_rois` a frame, on both paths (the JAX
CLI's watcher drops `--num_rois`).
"""

from __future__ import annotations

import argparse

import torch

from heterofusionrcnn_torch.experiments import common
from heterofusionrcnn_torch.inference import exact_float32
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
from heterofusionrcnn_torch.runtime.evaluator import (
    RcnnEvaluator,
    RpnEvaluator,
    repeated_checkpoint_run,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate RPN or RCNN checkpoints with the "
                                                 "PyTorch/CUDA port")
    parser.add_argument("--pipeline_config", required=True,
                        help="preset name or JSON config path")
    parser.add_argument("--data_split", default="val")
    parser.add_argument("--dataset_dir", default=None)
    parser.add_argument("--output_root", default="outputs")
    parser.add_argument("--ckpt_indices", type=int, nargs="*", default=[-1],
                        help="checkpoint steps to evaluate; -1 = latest")
    parser.add_argument("--save_rpn_feature", action="store_true")
    parser.add_argument("--for_rcnn_train", action="store_true")
    parser.add_argument("--evaluate_repeatedly", action="store_true")
    parser.add_argument("--proposal_dir", default=None,
                        help="RCNN only: dir of saved RPN proposals")
    parser.add_argument("--proposal_iou_dir", default=None,
                        help="RCNN only: dir of the proposals' 3D-IoU tables")
    parser.add_argument("--rpn_feature_dir", default=None,
                        help="RCNN only: dir of the RPN's per-point feature files")
    parser.add_argument("--num_rois", type=int, default=100,
                        help="RCNN only: proposals a frame (padded or cut)")
    parser.add_argument("--eval_batch_size", type=int, default=1,
                        help="samples per forward (the last batch padded by "
                             "repetition); the files are those of batch 1")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns [summary of each checkpoint evaluated once]
    (the watcher's evaluations are in the ledgers)."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available")
    cfg = common.resolve_config(args.pipeline_config, args.dataset_dir)
    model_kind = "rpn" if cfg.model_config.model_name == "rpn_model" else "rcnn"
    handoff = (args.proposal_dir, args.proposal_iou_dir, args.rpn_feature_dir)
    if model_kind == "rcnn" and None in handoff:
        raise ValueError(
            "evaluating the RCNN needs the RPN's handoff files of the split: pass "
            "--proposal_dir, --proposal_iou_dir and --rpn_feature_dir (run_evaluation of the "
            "RPN with --save_rpn_feature writes them)")
    exact_float32()
    # Eval runs without augmentation or path drop (run_evaluation.py:30-67).
    cfg.dataset_config.aug_list = []
    cfg.model_config.path_drop_probabilities = [1.0, 1.0]

    mode = "val" if cfg.dataset_config.has_labels else "test"
    dataset = common.build_dataset(cfg, mode, args.data_split)
    if args.for_rcnn_train:
        # Evaluate with the training NMS sizes so the RCNN sees 512 proposals.
        rpn = cfg.model_config.rpn_config
        rpn.rpn_test_pre_nms_size = rpn.rpn_train_pre_nms_size
        rpn.rpn_test_post_nms_size = rpn.rpn_train_post_nms_size
        rpn.rpn_test_nms_iou_thresh = rpn.rpn_train_nms_iou_thresh
    model, _ = common.build_model(cfg, dataset, mode, save_rpn_feature=args.save_rpn_feature)
    model = model.to(args.device).eval()
    if model_kind == "rcnn":
        dataset.proposal_dir, dataset.proposal_iou_dir, dataset.rpn_feature_dir = handoff
        evaluator = RcnnEvaluator(model, dataset, cfg, args.output_root,
                                  eval_batch_size=args.eval_batch_size)
        csv_name, eval_kwargs = "rcnn_eval.csv", {"num_rois": args.num_rois}
    else:
        evaluator = RpnEvaluator(model, dataset, cfg, args.output_root,
                                 save_rpn_feature=args.save_rpn_feature,
                                 eval_batch_size=args.eval_batch_size)
        csv_name, eval_kwargs = "rpn_total_recall.csv", {}

    name = cfg.model_config.checkpoint_name
    mgr = CheckpointManager(f"{args.output_root}/{name}/checkpoints")

    def make_state(step):
        return mgr.restore_raw(step)["state_dict"]

    summaries = []
    if args.evaluate_repeatedly:
        repeated_checkpoint_run(evaluator, mgr, make_state, csv_name, **eval_kwargs)
    else:
        steps = args.ckpt_indices
        if steps == [-1]:
            steps = [mgr.latest_step()]
        for step in steps:
            if step is None:
                raise SystemExit("no checkpoints found")
            summary = evaluator.run_checkpoint_once(make_state(step), step, **eval_kwargs)
            print({k: v for k, v in summary.items()})
            summaries.append(summary)
    mgr.close()
    return summaries


if __name__ == "__main__":
    main()
