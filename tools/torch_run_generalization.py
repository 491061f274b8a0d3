"""Generalization curves of the PyTorch port (counterpart of
tools/run_generalization.py): train on one split, evaluate every
checkpoint on a disjoint eval split, and write recall / AP curves against
the training step.

    python tools/torch_run_generalization.py --output_root outputs/gen \
        --rpn_iterations 3000 --rcnn_iterations 3000 --checkpoint_interval 300

Artifacts, under <output_root>/generalization/:
  rpn_recall_curve.csv   step, recall@0.5, recall@0.7, seg_acc   (eval split)
  rcnn_ap_curve.csv      step, car/ped/cyc 3D-moderate AP        (eval split)
  summary.json           the final train-split and eval-split AP, the curve

Both trainings are `experiments.run_training` on a config saved under
generalization/configs/ (the iterations, `--checkpoint_interval` and
`--img_downsample` applied); the evaluations are the port's
`RpnEvaluator` / `RcnnEvaluator`. The handoff files go under
<output_root>/handoff. Every sweep resumes: steps already in a curve (or
with an ap_<split>_<step>.json) are not evaluated again, and a finished
handoff split leaves a marker. Runs on the card unless given
`--device cpu`.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import csv
import json

from heterofusionrcnn_torch.configs.config import save_config
from heterofusionrcnn_torch.experiments import common, run_training
from heterofusionrcnn_torch.inference import exact_float32
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
from heterofusionrcnn_torch.runtime.evaluator import RcnnEvaluator, RpnEvaluator

RPN_CURVE_HEADER = ["step", "recall_50", "recall_70", "seg_acc"]
RCNN_CURVE_HEADER = ["step", "car_3d_moderate", "ped_3d_moderate", "cyc_3d_moderate"]
AP_KEYS = ("car_detection_3d", "pedestrian_detection_3d", "cyclist_detection_3d")


def _write_csv(path, header, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _read_csv_rows(path):
    """Data rows of an existing curve CSV (none if absent)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return list(csv.reader(f))[1:]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rpn_config", default="rpn_multiclass")
    parser.add_argument("--rcnn_config", default="rcnn_multiclass")
    parser.add_argument("--dataset_dir", default=None)
    parser.add_argument("--output_root", default="outputs/gen")
    parser.add_argument("--train_split", default="train")
    parser.add_argument("--eval_split", default="val")
    parser.add_argument("--rpn_iterations", type=int, default=3000)
    parser.add_argument("--rcnn_iterations", type=int, default=3000)
    parser.add_argument("--checkpoint_interval", type=int, default=300)
    parser.add_argument("--num_rois", type=int, default=100)
    parser.add_argument("--img_downsample", type=int, default=1,
                        help="image-extractor downsample factor, in training and evaluation")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval_batch_size", type=int, default=1,
                        help="samples per evaluation forward (the files are those of batch 1)")
    parser.add_argument("--resume_from_handoff", action="store_true",
                        help="skip the RPN's training, recall sweep and handoff: train and "
                             "evaluate the RCNN from the latest RPN checkpoint and the "
                             "handoff files under <output_root>/handoff")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the stages; returns the summary written to summary.json."""
    args = parse_args(argv)
    gen_dir = os.path.join(args.output_root, "generalization")
    os.makedirs(gen_dir, exist_ok=True)
    handoff_root = os.path.join(args.output_root, "handoff")

    def config(name, iterations=None, val=False, train_nms=False):
        cfg = common.resolve_config(name, args.dataset_dir)
        cfg.model_config.layers_config.img_vgg_pyr.downsample = args.img_downsample
        if iterations is not None:
            cfg.train_config.max_iterations = iterations
            cfg.train_config.checkpoint_interval = args.checkpoint_interval
        if val:
            cfg.dataset_config.aug_list = []
            cfg.model_config.path_drop_probabilities = [1.0, 1.0]
        if train_nms:
            # The handoff's proposals take the train NMS sizes, as the RCNN
            # trains on them.
            rpn = cfg.model_config.rpn_config
            rpn.rpn_test_pre_nms_size = rpn.rpn_train_pre_nms_size
            rpn.rpn_test_post_nms_size = rpn.rpn_train_post_nms_size
            rpn.rpn_test_nms_iou_thresh = rpn.rpn_train_nms_iou_thresh
        return cfg

    def train(name, iterations, seed, extra=()):
        """run_training on the config saved under generalization/configs."""
        cfg = config(name, iterations)
        path = os.path.join(gen_dir, "configs", cfg.model_config.checkpoint_name + ".json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_config(cfg, path)
        run_training.main(["--pipeline_config", path, "--data_split", args.train_split,
                           "--output_root", args.output_root, "--seed", str(seed),
                           "--device", args.device, *extra])
        return CheckpointManager(os.path.join(args.output_root, cfg.model_config.checkpoint_name,
                                              "checkpoints"))

    def evaluator(cfg, split, root, dirs=None, save_rpn_feature=False):
        ds = common.build_dataset(cfg, "val", split)
        if dirs is not None:
            ds.proposal_dir, ds.proposal_iou_dir, ds.rpn_feature_dir = dirs
        model, _ = common.build_model(cfg, ds, "val", save_rpn_feature=save_rpn_feature)
        model = model.to(args.device).eval()
        if dirs is None:
            return RpnEvaluator(model, ds, cfg, root, save_rpn_feature=save_rpn_feature,
                                eval_batch_size=args.eval_batch_size)
        return RcnnEvaluator(model, ds, cfg, root, eval_batch_size=args.eval_batch_size)

    exact_float32()
    rpn_name = config(args.rpn_config).model_config.checkpoint_name
    curve_path = os.path.join(gen_dir, "rpn_recall_curve.csv")
    if args.resume_from_handoff:
        mgr = CheckpointManager(os.path.join(args.output_root, rpn_name, "checkpoints"))
        rpn_step = mgr.latest_step()
        curve = _read_csv_rows(curve_path)
        print(f"[gen] resume: RPN step {rpn_step}, handoff at {handoff_root}", flush=True)
    else:
        # Stage 1: the RPN on the train split.
        mgr = train(args.rpn_config, args.rpn_iterations, args.seed)
        rpn_step = mgr.latest_step()
        print(f"[gen] RPN trained to step {rpn_step}", flush=True)

        # Stage 1b: the recall curve on the eval split, rewritten after
        # every checkpoint.
        ev = evaluator(config(args.rpn_config, val=True), args.eval_split, args.output_root)
        curve = _read_csv_rows(curve_path)
        done = {int(float(r[0])) for r in curve}
        for step in mgr.all_steps():
            if step in done:
                continue
            s = ev.run_checkpoint_once(mgr.restore_raw(step)["state_dict"], step)
            curve.append([step, round(s["recall_50"], 4), round(s["recall_70"], 4),
                          round(s.get("avg_seg_acc", 0.0), 4)])
            curve.sort(key=lambda r: int(float(r[0])))
            print(f"[gen] RPN step {step}: val recall@0.5={s['recall_50']:.3f} "
                  f"@0.7={s['recall_70']:.3f}", flush=True)
            _write_csv(curve_path, RPN_CURVE_HEADER, curve)
        del ev

        # Stage 1c: the handoff from the final RPN, under a root of its own
        # (the recall sweep wrote this step's proposals under output_root,
        # and the evaluator skips frames whose proposals exist).
        hand_cfg = config(args.rpn_config, val=True, train_nms=True)
        state_dict = mgr.restore_raw(rpn_step)["state_dict"]
        for split in dict.fromkeys([args.train_split, args.eval_split]):
            marker = os.path.join(handoff_root, f".done_{split}_{rpn_step}")
            if os.path.exists(marker):
                print(f"[gen] handoff {split}: done (marker)", flush=True)
                continue
            s = evaluator(hand_cfg, split, handoff_root,
                          save_rpn_feature=True).run_checkpoint_once(state_dict, rpn_step)
            with open(marker, "w") as f:
                f.write("done\n")
            print(f"[gen] handoff {split}: recall@0.5={s['recall_50']:.3f}", flush=True)
    pred_base = os.path.join(handoff_root, rpn_name, "predictions")

    def handoff_dirs(split):
        return [os.path.join(pred_base, kind, split, str(rpn_step))
                for kind in ("proposals_and_scores", "proposals_iou", "rpn_feature")]

    # Stage 2: the RCNN on the train split, warm-started from the RPN.
    dirs = handoff_dirs(args.train_split)
    rmgr = train(args.rcnn_config, args.rcnn_iterations, args.seed + 1, extra=[
        "--warm_start_from", os.path.join(args.output_root, rpn_name, "checkpoints"),
        "--proposal_dir", dirs[0], "--proposal_iou_dir", dirs[1], "--rpn_feature_dir", dirs[2]])
    rcnn_step = rmgr.latest_step()
    print(f"[gen] RCNN trained to step {rcnn_step}", flush=True)

    # Stage 2b: the AP curve on the eval split; the final step's AP on the
    # train split too, for the gap.
    rv_cfg = config(args.rcnn_config, val=True)

    def eval_split_ckpts(split, steps, curve_csv=None):
        ev = evaluator(rv_cfg, split, args.output_root, dirs=handoff_dirs(split))
        out = []
        for step in steps:
            ap_ledger = os.path.join(gen_dir, f"ap_{split}_{step}.json")
            if os.path.exists(ap_ledger):
                with open(ap_ledger) as f:
                    ap = {k: tuple(v) for k, v in json.load(f).items()}
            else:
                s = ev.run_checkpoint_once(rmgr.restore_raw(step)["state_dict"], step,
                                           num_rois=args.num_rois)
                ap = s.get("ap", {})
                with open(ap_ledger, "w") as f:
                    json.dump({k: list(v) for k, v in ap.items()}, f)
            row = [step] + [round(ap.get(k, (0, 0, 0))[1], 2) for k in AP_KEYS]
            out.append((row, ap))
            print(f"[gen] RCNN step {step} [{split}]: car3D-mod={row[1]} "
                  f"ped3D-mod={row[2]} cyc3D-mod={row[3]}", flush=True)
            if curve_csv:
                _write_csv(curve_csv, RCNN_CURVE_HEADER, [r for r, _ in out])
        return out

    val_curve = eval_split_ckpts(args.eval_split, rmgr.all_steps(),
                                 os.path.join(gen_dir, "rcnn_ap_curve.csv"))
    train_final = eval_split_ckpts(args.train_split, [rcnn_step])

    summary = {
        "train_split": args.train_split,
        "eval_split": args.eval_split,
        "rpn_steps": rpn_step,
        "rcnn_steps": rcnn_step,
        "val_recall_curve": curve,
        "val_ap_final": val_curve[-1][1] if val_curve else {},
        "train_ap_final": train_final[0][1] if train_final else {},
    }
    with open(os.path.join(gen_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=list)
    print(f"[gen] wrote {gen_dir}/summary.json", flush=True)
    return summary


if __name__ == "__main__":
    main()
