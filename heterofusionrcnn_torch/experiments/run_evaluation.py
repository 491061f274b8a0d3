"""Evaluation CLI, the RPN stage (PyTorch port of heterofusionrcnn_tpu/
experiments/run_evaluation.py). Runs on the card unless given
`--device cpu`.

    python -m heterofusionrcnn_torch.experiments.run_evaluation \\
        --pipeline_config rpn_multiclass --data_split train \\
        --save_rpn_feature --for_rcnn_train --output_root outputs

Evaluates the checkpoints `--ckpt_indices` (default: the latest) of
<output_root>/<checkpoint_name>/checkpoints with `runtime.evaluator.
RpnEvaluator`, without augmentation or path drop. `--save_rpn_feature`
writes the per-point feature files of the RPN -> RCNN handoff;
`--for_rcnn_train` switches the RPN's NMS to the train sizes (512
proposals), so the saved proposals feed RCNN training (reference
run_evaluation.py:149-162). The RCNN's evaluation and `--evaluate_repeatedly`
are not ported yet and raise.
"""

from __future__ import annotations

import argparse

import torch

from heterofusionrcnn_torch.experiments import common
from heterofusionrcnn_torch.inference import exact_float32
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
from heterofusionrcnn_torch.runtime.evaluator import RpnEvaluator

_NEXT_SLICE = "not ported yet (ROADMAP Queue 1, item 1: RcnnEvaluator, repeated_checkpoint_run)"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate RPN checkpoints with the "
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
    parser.add_argument("--eval_batch_size", type=int, default=1,
                        help="samples per forward (the last batch padded by "
                             "repetition); the files are those of batch 1")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns [summary of each evaluated checkpoint]."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available")
    cfg = common.resolve_config(args.pipeline_config, args.dataset_dir)
    if cfg.model_config.model_name != "rpn_model":
        raise NotImplementedError(f"evaluating {cfg.model_config.model_name}: {_NEXT_SLICE}")
    if args.evaluate_repeatedly:
        raise NotImplementedError(f"--evaluate_repeatedly: {_NEXT_SLICE}")
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
    evaluator = RpnEvaluator(model, dataset, cfg, args.output_root,
                             save_rpn_feature=args.save_rpn_feature,
                             eval_batch_size=args.eval_batch_size)

    name = cfg.model_config.checkpoint_name
    mgr = CheckpointManager(f"{args.output_root}/{name}/checkpoints")
    steps = args.ckpt_indices
    if steps == [-1]:
        steps = [mgr.latest_step()]
    summaries = []
    for step in steps:
        if step is None:
            raise SystemExit("no checkpoints found")
        summary = evaluator.run_checkpoint_once(mgr.restore_raw(step)["state_dict"], step)
        print({k: v for k, v in summary.items()})
        summaries.append(summary)
    mgr.close()
    return summaries


if __name__ == "__main__":
    main()
