"""Checkpoint evaluators (PyTorch port of
heterofusionrcnn_tpu/runtime/evaluator.py `RpnEvaluator`, `RcnnEvaluator`,
`evaluated_steps`, `repeated_checkpoint_run`).

`RpnEvaluator` runs a val or test epoch of the RPN for one checkpoint and
writes the files the RCNN trains from, in the JAX evaluator's layout and
formats, under <output_root>/<checkpoint_name>/predictions:

  proposals_and_scores/<split>/<step>/<sample>.txt  rows box + score, %.3f
  proposals_iou/<split>/<step>/<sample>.txt         (n, m_gt) 3D-IoU table
  rpn_feature/<split>/<step>/<sample>.npy           [pts, intensity,
                                                     fg_mask, pc_fts, img_fts]

and the ledgers rpn_avg_losses.csv, rpn_avg_seg_acc.csv and
rpn_total_recall.csv beside them (plus a headed rpn_total_recall.csv under
logs/).

`RcnnEvaluator` runs the RCNN over a split's handoff files and writes

  final_predictions_and_scores/<split>/<step>/<sample>.txt  rows box +
      score + class, de-duplicated, by descending score, %.5f
  kitti_native_eval/<threshold>/<step>/data/<sample>.txt    KITTI rows

with, on a labelled split, the native evaluator's ap_summary.json at the
standard and (results_05_iou/) the relaxed thresholds, the ledgers
rcnn_avg_losses.csv and rcnn_avg_cls_acc.csv, and logs/rcnn_eval.csv.

Losses and accuracies are per sample (one batch row at a time), so the
ledgers do not depend on `eval_batch_size`. The forwards run under
`torch.no_grad()` in eval mode: on the card the fused XConv kernel has no
backward.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from heterofusionrcnn_torch.models.rcnn import rcnn_loss
from heterofusionrcnn_torch.models.rpn import rpn_fts_channels, rpn_loss
from heterofusionrcnn_torch.runtime.kitti_writer import save_predictions_in_kitti_format
from heterofusionrcnn_torch.runtime.native_eval import run_kitti_native_eval
from heterofusionrcnn_torch.runtime.train_state import RPN_BATCH_KEYS
from heterofusionrcnn_torch.utils.metrics import compute_recall_iou

# The val-mode predictions `rpn_loss` reads.
_RPN_LOSS_KEYS = ("foreground_mask", "seg_softmax", "seg_gt_one_hot", "cls_preds", "cls_gts",
                  "reg_preds", "reg_gts")
# The val-mode predictions `rcnn_loss` and the per-sample accuracy read.
_RCNN_LOSS_KEYS = ("cls_logits", "cls_gt_one_hot", "pos_neg_cls_mask", "pos_reg_mask",
                   "mb_cls_preds", "mb_cls_gts", "mb_reg_preds", "mb_reg_gts")
# The predictions the RCNN's files read.
_RCNN_HOST_KEYS = ("final_boxes", "final_scores", "final_classes", "num_boxes_before_padding")
# The predictions the files and metrics read, where the mode has them.
_HOST_KEYS = ("proposals", "proposal_scores", "num_proposals_before_padding", "proposal_iou3d",
              "proposal_iou2d", "seg_accuracy", "rpn_pts", "rpn_intensity", "foreground_mask",
              "rpn_fts", "rpn_img_fts")


def _append_csv(path, header, row):
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(header)
        w.writerow(row)


def _append_ledger_row(path, values, fmt):
    """Append one row in the reference's np.savetxt CSV format
    (evaluator.py:683-726 — '%d, %.5f, ...', no header)."""
    with open(path, "ba") as fp:
        np.savetxt(fp, np.reshape(np.asarray(values, np.float64), (1, -1)), fmt=fmt)


def _iter_eval_batches(ds, batch_size, model, skip_name, **load_kwargs):
    """Deterministic epoch sweep over `ds.sample_list` in index order,
    collated to a fixed batch size.

    Samples for which `skip_name(name)` is True are skipped before loading
    (the reference's skip-existing resume, evaluator.py:218-231). The final
    partial batch is padded by repeating its last sample; padded rows are
    marked False in the yielded `valid` mask and must not be written or
    counted by the caller.

    Yields (batch_dict, names, valid) with len(names) == batch_size.
    """
    buf = []
    idx = 0
    n = ds.num_samples
    while True:
        while idx < n and len(buf) < batch_size:
            want = []
            while idx < n and len(buf) + len(want) < batch_size:
                if not skip_name(ds.sample_list[idx].name):
                    want.append(idx)
                idx += 1
            if want:
                # load_samples may return fewer dicts than asked (label-less
                # samples are skipped by the loaders) — just keep filling.
                buf.extend(ds.load_samples(np.asarray(want), model=model, **load_kwargs))
        if not buf:
            return
        take = buf[:batch_size]
        buf = buf[batch_size:]
        n_valid = len(take)
        while len(take) < batch_size:
            take.append(take[-1])
        batch, names = ds.collate_batch(take)
        valid = np.zeros(batch_size, bool)
        valid[:n_valid] = True
        yield batch, names, valid


def _time_stats(times):
    """min/max/mean/median inference-time stats (reference
    evaluator_utils.print_inference_time_statistics :222-238)."""
    if not times:
        return {"min": 0.0, "max": 0.0, "mean": 0.0, "median": 0.0}
    a = np.asarray(times)
    return {
        "min": float(np.min(a)),
        "max": float(np.max(a)),
        "mean": float(np.mean(a)),
        "median": float(np.median(a)),
    }


def _host(t: torch.Tensor) -> np.ndarray:
    """A prediction on the host. numpy has no bf16: bf16 features (the
    bf16 serving path's `rpn_fts`, `rpn_img_fts`) widen to float32 exactly,
    so the handoff file is the float32 one the JAX evaluator's `np.hstack`
    of float32 points and bf16 features writes."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _rows(tree, start, stop):
    """Rows [start, stop) of a tensor, or of each tensor of a tuple."""
    if isinstance(tree, tuple):
        return tuple(t[start:stop] for t in tree)
    return tree[start:stop]


class RpnEvaluator:
    """Stage-1 evaluator: proposal generation + metrics + RCNN handoff files.

    `model`: an `RpnModel` in "val" mode (a labelled split: losses, IoU
    tables, recall) or "test" mode, built with `save_rpn_feature` when the
    feature files are wanted, on the device the evaluation runs on."""

    def __init__(self, model, dataset, pipeline_cfg, output_root: str,
                 save_rpn_feature: bool = False, eval_batch_size: int = 1):
        self.model = model
        self.dataset = dataset
        self.cfg = pipeline_cfg
        self.save_rpn_feature = save_rpn_feature
        self.eval_batch_size = max(int(eval_batch_size), 1)
        name = pipeline_cfg.model_config.checkpoint_name
        self.predictions_dir = os.path.join(output_root, name, "predictions")
        self.logs_dir = os.path.join(output_root, name, "logs")
        os.makedirs(self.predictions_dir, exist_ok=True)
        os.makedirs(self.logs_dir, exist_ok=True)
        self._has_labels = getattr(dataset, "has_labels", True)
        # Val mode carries the loss targets: the reference evaluates the
        # losses at eval time and appends per-checkpoint ledgers
        # (evaluator.py:623-797).
        self._with_loss = self._has_labels and getattr(model, "mode", "") == "val"

    @torch.no_grad()
    def _apply(self, batch):
        """The model's forward on one host batch; returns the predictions
        and the per-sample losses ({name: (B,)}, or None), on the host."""
        model = self.model.eval()
        device = next(model.parameters()).device
        keys = RPN_BATCH_KEYS if self._has_labels else RPN_BATCH_KEYS[:3]
        inputs = [torch.from_numpy(batch[k]).to(device) for k in keys]
        preds = model(*inputs)
        losses = None
        if self._with_loss:
            per_sample = []
            for b in range(inputs[0].shape[0]):
                loss_dict, total = rpn_loss(
                    {k: _rows(preds[k], b, b + 1) for k in _RPN_LOSS_KEYS}, self.cfg.model_config)
                per_sample.append(dict(loss_dict, rpn_total_loss=total))
            losses = {k: torch.stack([d[k] for d in per_sample]).cpu().numpy()
                      for k in per_sample[0]}
            # Per-sample seg accuracy (the model's batch-mean formula, equal
            # at B=1).
            preds["seg_accuracy"] = (preds["seg_preds"] == inputs[3].long()).float().mean(1)
        return {k: _host(preds[k]) for k in _HOST_KEYS if k in preds}, losses

    def run_checkpoint_once(self, state_dict, global_step) -> dict:
        """Load `state_dict` into the model (None: keep its weights) and
        evaluate it as checkpoint `global_step`; returns the summary."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        ds = self.dataset
        ic = self.cfg.model_config.input_config
        split = ds.data_split
        base = self.predictions_dir

        prop_dir = os.path.join(base, "proposals_and_scores", split, str(global_step))
        os.makedirs(prop_dir, exist_ok=True)
        iou_dir = os.path.join(base, "proposals_iou", split, str(global_step))
        os.makedirs(iou_dir, exist_ok=True)
        if self.save_rpn_feature:
            feat_dir = os.path.join(base, "rpn_feature", split, str(global_step))
            os.makedirs(feat_dir, exist_ok=True)

        stats = {
            "seg_acc": [],
            "recall_50": 0,
            "recall_70": 0,
            "num_gt": 0,
            "num_proposals": [],
            "iou2d": [],
            "iou3d": [],
            "angle_res": 0.0,
        }
        losses = {}
        infer_times = []

        def _done(name):
            # Crude resumability (evaluator.py:218-231): skip samples whose
            # output already exists from an interrupted run.
            return os.path.exists(os.path.join(prop_dir, name + ".txt"))

        for batch, names, valid in _iter_eval_batches(
            ds,
            self.eval_batch_size,
            "rpn",
            _done,
            pc_sample_pts=ic.pc_sample_pts,
            img_w=ic.img_dims_w,
            img_h=ic.img_dims_h,
        ):
            t0 = time.time()
            preds, loss_host = self._apply(batch)
            per_sample_time = (time.time() - t0) / len(valid)

            for b in np.flatnonzero(valid):
                infer_times.append(per_sample_time)
                if loss_host is not None:
                    for k, v in loss_host.items():
                        losses.setdefault(k, []).append(float(v[b]))

                name = names[b]
                n_valid = int(preds["num_proposals_before_padding"][b])
                proposals = preds["proposals"][b][:n_valid]
                scores = preds["proposal_scores"][b][:n_valid]
                np.savetxt(
                    os.path.join(prop_dir, name + ".txt"),
                    np.hstack([proposals, scores[:, None]]),
                    fmt="%.3f",
                )

                if self._has_labels:
                    m = int(batch["label_num_boxes"][b])
                    label_boxes = batch["label_boxes_3d"][b][:m]
                    label_cls = batch["label_classes"][b][:m]
                    iou3d_table = preds["proposal_iou3d"][b][:n_valid, :m]
                    iou2d_table = preds["proposal_iou2d"][b][:n_valid, :m]
                    np.savetxt(os.path.join(iou_dir, name + ".txt"), iou3d_table)

                    r50, r70, iou2ds, iou3ds, iou3ds_gt_boxes, _, _ = compute_recall_iou(
                        proposals, label_boxes, label_cls, iou2d_table, iou3d_table)
                    stats["recall_50"] += r50
                    stats["recall_70"] += r70
                    stats["num_gt"] += m
                    stats["iou2d"].extend(iou2ds.tolist())
                    stats["iou3d"].extend(iou3ds.tolist())
                    # Angle residual vs the best-IoU GT (reference
                    # evaluator.py:1047-1049).
                    if n_valid > 0:
                        stats["angle_res"] += float(
                            np.sum(np.abs(proposals[:, 6] - iou3ds_gt_boxes[:, 6])))
                if "seg_accuracy" in preds:
                    acc = preds["seg_accuracy"]
                    stats["seg_acc"].append(float(acc[b]) if acc.ndim else float(acc))
                stats["num_proposals"].append(n_valid)

                if self.save_rpn_feature:
                    arr = np.hstack([
                        preds["rpn_pts"][b],
                        preds["rpn_intensity"][b].reshape(-1, 1),
                        preds["foreground_mask"][b].reshape(-1, 1).astype(np.float32),
                        preds["rpn_fts"][b],
                        preds["rpn_img_fts"][b],
                    ])
                    np.save(os.path.join(feat_dir, name + ".npy"), arr)

        tstats = _time_stats(infer_times)
        num_proposals_total = max(int(np.sum(stats["num_proposals"])), 1)
        summary = {
            "global_step": int(global_step),
            "avg_seg_acc": float(np.mean(stats["seg_acc"])) if stats["seg_acc"] else 0.0,
            "recall_50": stats["recall_50"] / max(stats["num_gt"], 1),
            "recall_70": stats["recall_70"] / max(stats["num_gt"], 1),
            "avg_num_proposals": float(np.mean(stats["num_proposals"])),
            "avg_iou2d": float(np.mean(stats["iou2d"])) if stats["iou2d"] else 0.0,
            "avg_iou3d": float(np.mean(stats["iou3d"])) if stats["iou3d"] else 0.0,
            "avg_angle_res": stats["angle_res"] / num_proposals_total,
            "avg_inference_time": tstats["mean"],
            "inference_time_stats": tstats,
        }
        print(
            "Inference time: Min: {min:.5f} Max: {max:.5f} Mean: {mean:.5f} "
            "Median: {median:.5f}".format(**tstats)
        )
        _append_csv(
            os.path.join(self.logs_dir, "rpn_total_recall.csv"),
            [k for k in summary if k != "inference_time_stats"],
            [v for k, v in summary.items() if k != "inference_time_stats"],
        )

        # Reference-format per-checkpoint ledgers at the predictions base dir
        # (evaluator.py:683-726).
        if losses:
            n_samp = max(len(losses["rpn_total_loss"]), 1)
            avg = {k: sum(v) / n_samp for k, v in losses.items()}
            summary["avg_losses"] = avg
            _append_ledger_row(
                os.path.join(self.predictions_dir, "rpn_avg_losses.csv"),
                [global_step, avg["rpn_seg_loss"], avg["rpn_bin_cls_loss"],
                 avg["rpn_reg_loss"], avg["rpn_total_loss"]],
                "%d, %.5f, %.5f, %.5f, %5f",
            )
            print(
                "Step {}: Average RPN Losses: segmentation {:.3f}, bin_cls "
                "{:.3f}, regression {:.3f}, total {:.3f}".format(
                    global_step, avg["rpn_seg_loss"], avg["rpn_bin_cls_loss"],
                    avg["rpn_reg_loss"], avg["rpn_total_loss"],
                )
            )
        if stats["seg_acc"]:
            _append_ledger_row(
                os.path.join(self.predictions_dir, "rpn_avg_seg_acc.csv"),
                [global_step, summary["avg_seg_acc"]],
                "%d, %.5f",
            )
        if self._has_labels:
            _append_ledger_row(
                os.path.join(self.predictions_dir, "rpn_total_recall.csv"),
                [global_step, summary["recall_50"], summary["recall_70"],
                 summary["avg_num_proposals"], summary["avg_iou2d"],
                 summary["avg_iou3d"], summary["avg_angle_res"]],
                "%d, %.5f, %.5f, %.5f, %.5f, %.5f, %.5f",
            )
        return summary


class RcnnEvaluator:
    """Stage-2 evaluator: final predictions, KITTI-format conversion, AP.

    `model`: an `RcnnModel` in "val" mode (a labelled split: losses and
    classification accuracy) or "test" mode, on the device the evaluation
    runs on; `dataset` has the handoff directories of the split set
    (`proposal_dir`, `proposal_iou_dir`, `rpn_feature_dir`)."""

    def __init__(self, model, dataset, pipeline_cfg, output_root: str,
                 eval_batch_size: int = 1):
        self.model = model
        self.dataset = dataset
        self.cfg = pipeline_cfg
        self.eval_batch_size = max(int(eval_batch_size), 1)
        name = pipeline_cfg.model_config.checkpoint_name
        self.predictions_dir = os.path.join(output_root, name, "predictions")
        self.logs_dir = os.path.join(output_root, name, "logs")
        os.makedirs(self.predictions_dir, exist_ok=True)
        os.makedirs(self.logs_dir, exist_ok=True)
        self._with_loss = getattr(dataset, "has_labels", True) and (
            getattr(model, "mode", "") == "val")

    @torch.no_grad()
    def _apply(self, batch):
        """The model's forward on one host batch; returns the predictions
        on the host, with the per-sample "cls_accuracy" (B,) in val mode,
        and the per-sample losses ({name: (B,)}, or None). The RCNN
        flattens batch x RoIs batch-major, so sample b's RoIs are rows
        b * n .. (b + 1) * n of each loss input."""
        model = self.model.eval()
        device = next(model.parameters()).device
        t = {k: torch.from_numpy(batch[k]).to(device) for k in (
            "rpn_roi", "rpn_iou", "rpn_gt", "rpn_pts", "rpn_intensity", "rpn_fg_mask", "rpn_fts",
            "image_input", "stereo_calib_p2")}
        preds = model(t["rpn_roi"], t["rpn_pts"], t["rpn_intensity"], t["rpn_fg_mask"],
                      t["rpn_fts"], t["image_input"], t["stereo_calib_p2"],
                      proposals_iou=t["rpn_iou"], proposals_gt=t["rpn_gt"])
        host = {k: _host(preds[k]) for k in _RCNN_HOST_KEYS}
        if not self._with_loss:
            return host, None
        b, n = t["rpn_roi"].shape[:2]
        per_sample, accs = [], []
        for i in range(b):
            rows = {k: _rows(preds[k], i * n, (i + 1) * n) for k in _RCNN_LOSS_KEYS}
            loss_dict, total = rcnn_loss(rows, self.cfg.model_config)
            per_sample.append(dict(loss_dict, rcnn_total_loss=total))
            # The model's batch accuracy on one sample's rows (equal at B=1).
            m = rows["pos_neg_cls_mask"].float()
            hits = (rows["cls_logits"].argmax(-1) == rows["cls_gt_one_hot"].argmax(-1)).float()
            accs.append((hits * m).sum() / m.sum().clamp(min=1))
        host["cls_accuracy"] = torch.stack(accs).cpu().numpy()
        losses = {k: torch.stack([d[k] for d in per_sample]).cpu().numpy()
                  for k in per_sample[0]}
        return host, losses

    def run_checkpoint_once(self, state_dict, global_step, num_rois: int = 100) -> dict:
        """Load `state_dict` into the model (None: keep its weights) and
        evaluate it as checkpoint `global_step`, each frame's proposals
        padded or cut to `num_rois`; returns the summary."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        ds = self.dataset
        ic = self.cfg.model_config.input_config
        final_dir = os.path.join(self.predictions_dir, "final_predictions_and_scores",
                                 ds.data_split, str(global_step))
        os.makedirs(final_dir, exist_ok=True)

        infer_times = []
        cls_accs = []
        losses = {}

        def _done(name):
            return os.path.exists(os.path.join(final_dir, name + ".txt"))

        for batch, names, valid in _iter_eval_batches(
            ds,
            self.eval_batch_size,
            "rcnn",
            _done,
            img_w=ic.img_dims_w,
            img_h=ic.img_dims_h,
            num_rois=num_rois,
            rpn_fts_channels=rpn_fts_channels(self.cfg.model_config),
        ):
            t0 = time.time()
            preds, loss_host = self._apply(batch)
            per_sample_time = (time.time() - t0) / len(valid)

            for b in np.flatnonzero(valid):
                infer_times.append(per_sample_time)
                if loss_host is not None:
                    for k, v in loss_host.items():
                        losses.setdefault(k, []).append(float(v[b]))
                    cls_accs.append(float(preds["cls_accuracy"][b]))

                n_valid = int(preds["num_boxes_before_padding"][b])
                boxes = preds["final_boxes"][b][:n_valid]
                scores = preds["final_scores"][b][:n_valid]
                types = preds["final_classes"][b][:n_valid]
                # Dedup (NMS padding may duplicate boxes; reference
                # save_rcnn_predicted_boxes_3d_and_scores :1104-1108).
                boxes, uniq = np.unique(boxes, axis=0, return_index=True)
                scores = scores[uniq]
                types = types[uniq]
                order = np.argsort(-scores)
                rows = np.column_stack([boxes, scores, types])[order]
                np.savetxt(os.path.join(final_dir, names[b] + ".txt"), rows, fmt="%.5f")

        kitti_dir = save_predictions_in_kitti_format(
            ds, self.predictions_dir, self.cfg.eval_config.kitti_score_threshold, global_step)
        tstats = _time_stats(infer_times)
        summary = {
            "global_step": int(global_step),
            "avg_cls_acc": float(np.mean(cls_accs)) if cls_accs else 0.0,
            "avg_inference_time": tstats["mean"],
            "inference_time_stats": tstats,
            "kitti_predictions_dir": kitti_dir,
        }
        print(
            "Inference time: Min: {min:.5f} Max: {max:.5f} Mean: {mean:.5f} "
            "Median: {median:.5f}".format(**tstats)
        )

        # Reference-format per-checkpoint ledgers (evaluator.py:766-797).
        if losses:
            n_samp = max(len(losses["rcnn_total_loss"]), 1)
            avg = {k: sum(v) / n_samp for k, v in losses.items()}
            summary["avg_losses"] = avg
            _append_ledger_row(
                os.path.join(self.predictions_dir, "rcnn_avg_losses.csv"),
                [global_step, avg["rcnn_cls_loss"], avg["rcnn_bin_cls_loss"],
                 avg["rcnn_reg_loss"], avg["rcnn_total_loss"]],
                "%d, %.5f, %.5f, %.5f, %.5f",
            )
            print(
                "Step {}: Average RCNN Losses: cls {:.5f}, bin_cls {:.5f}, "
                "reg {:.5f}, total {:.5f}".format(
                    global_step, avg["rcnn_cls_loss"], avg["rcnn_bin_cls_loss"],
                    avg["rcnn_reg_loss"], avg["rcnn_total_loss"],
                )
            )
        if cls_accs:
            _append_ledger_row(
                os.path.join(self.predictions_dir, "rcnn_avg_cls_acc.csv"),
                [global_step, summary["avg_cls_acc"]],
                "%d, %.5f",
            )

        # Offline AP through the native evaluator, at the standard and at
        # the relaxed (0.5 / 0.25 BEV and 3D) thresholds (reference
        # evaluator.py:1152-1192).
        if ds.has_labels:
            for key, out_dir, low_iou in (
                ("ap", os.path.dirname(kitti_dir), False),
                ("ap_05_iou", os.path.join(os.path.dirname(kitti_dir), "results_05_iou"), True),
            ):
                aps = run_kitti_native_eval(ds.label_dir, kitti_dir, out_dir, low_iou=low_iou)
                with open(os.path.join(out_dir, "ap_summary.json"), "w") as f:
                    json.dump({k: list(v) for k, v in aps.items()}, f, indent=2)
                summary[key] = aps
        _append_csv(
            os.path.join(self.logs_dir, "rcnn_eval.csv"),
            ["global_step", "avg_cls_acc", "avg_inference_time"],
            [summary["global_step"], summary["avg_cls_acc"], summary["avg_inference_time"]],
        )
        return summary


def evaluated_steps(logs_dir: str, csv_name: str):
    """Steps already present in the headed metrics ledger `csv_name` under
    `logs_dir` (the reference's skip_evaluated_checkpoints,
    evaluator.py:835-872)."""
    path = os.path.join(logs_dir, csv_name)
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        rows = list(csv.reader(f))
    return {int(float(r[0])) for r in rows[1:] if r}


def repeated_checkpoint_run(
    evaluator,
    ckpt_manager,
    make_state: Callable[[int], dict],
    csv_name: str,
    interval_secs: float = 30.0,
    max_wait_secs: float = 3600.0,
    stop_at_step: Optional[int] = None,
    **eval_kwargs,
):
    """Watch the checkpoint directory, evaluating each new step once
    (evaluator.py:435-502): `evaluator.run_checkpoint_once(make_state(step),
    step, **eval_kwargs)` for every step not yet in the ledger `csv_name`,
    then a wait of `interval_secs`; returns once `stop_at_step` is
    evaluated, or after `max_wait_secs` without a new checkpoint.

    Unlike the JAX package's watcher, which drops them, `eval_kwargs` (the
    RCNN's `num_rois`) reach every evaluation, as they reach the one-shot
    path."""
    waited = 0.0
    while True:
        done = evaluated_steps(evaluator.logs_dir, csv_name)
        todo = [s for s in ckpt_manager.all_steps() if s not in done]
        for step in todo:
            evaluator.run_checkpoint_once(make_state(step), step, **eval_kwargs)
        if todo:
            waited = 0.0
        if stop_at_step is not None and stop_at_step in evaluated_steps(
                evaluator.logs_dir, csv_name):
            return
        waited += interval_secs
        if waited > max_wait_secs:
            return
        time.sleep(interval_secs)
