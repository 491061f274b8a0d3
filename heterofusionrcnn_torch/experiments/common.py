"""Shared experiment wiring of the port (heterofusionrcnn_tpu/
experiments/common.py): config resolution, the dataset, the test-mode
two-stage detector, either stage in train, val or test mode with its loss,
the RCNN's train step and the batch functions of both stages."""

from __future__ import annotations

import os

from typing import Callable, Dict

import numpy as np
import torch

from heterofusionrcnn_torch.configs import config as config_lib
from heterofusionrcnn_torch.configs import presets
from heterofusionrcnn_torch.datasets.kitti.dataset import KittiDataset
from heterofusionrcnn_torch.inference import TwoStageDetector
from heterofusionrcnn_torch.models.rcnn import RcnnModel, rcnn_loss
from heterofusionrcnn_torch.models.rpn import RpnModel, rpn_fts_channels, rpn_loss
from heterofusionrcnn_torch.parallel.mesh import rows_per_rank
from heterofusionrcnn_torch.runtime.train_state import RPN_BATCH_KEYS, TrainState, train_step

PRESETS = {
    "rpn_multiclass": presets.rpn_multiclass,
    "rcnn_multiclass": presets.rcnn_multiclass,
    "rpn_unittest": presets.rpn_unittest,
    "rcnn_unittest": presets.rcnn_unittest,
}


def resolve_config(name_or_path: str, dataset_dir: str | None = None):
    """A preset name, or a JSON config file path whose checkpoint_name equals
    its file name."""
    if name_or_path in PRESETS:
        cfg = PRESETS[name_or_path]()
    elif os.path.exists(name_or_path):
        cfg = config_lib.load_config(name_or_path)
        base = os.path.splitext(os.path.basename(name_or_path))[0]
        if cfg.model_config.checkpoint_name != base:
            raise ValueError(
                f"checkpoint_name '{cfg.model_config.checkpoint_name}' must "
                f"equal the config file name '{base}'"
            )
    else:
        raise ValueError(f"unknown config {name_or_path}")
    if dataset_dir:
        cfg.dataset_config.dataset_dir = dataset_dir
    return cfg


def build_dataset(cfg, train_val_test: str, data_split: str | None = None):
    dcfg = cfg.dataset_config
    if data_split:
        dcfg.data_split = data_split
    return KittiDataset(dcfg, train_val_test)


def cluster_sizes_tuple(dataset):
    """The dataset's per-class mean sizes [l, w, h] (first cluster of each
    class), the bin codec's mean sizes."""
    return tuple(
        tuple(np.asarray(c).reshape(-1, 3)[0].tolist()) for c in dataset.clusters
    )


def build_model(cfg, dataset, mode: str, save_rpn_feature: bool = False, group=None):
    """The model of `cfg` (the RPN or the RCNN) in `mode` ("train", "val"
    or "test") with the dataset's classes and mean sizes, on the CPU, and
    its loss function (predictions -> (loss_dict, total)). The RCNN takes
    its target thresholds from the dataset's mini-batch config and its
    distance normaliser from the far BEV extent; `save_rpn_feature` makes
    the RPN return its per-point features (the RPN evaluator's handoff).
    With a data-parallel `group` the loss is this rank's share of the
    global loss (the model takes the group from `TrainState.create`)."""
    mc = cfg.model_config
    clusters = cluster_sizes_tuple(dataset)
    if mc.model_name == "rpn_model":
        model = RpnModel(mc, dataset.num_classes, clusters,
                         save_rpn_feature=save_rpn_feature, mode=mode)
        return model, lambda preds: rpn_loss(preds, mc, group)
    mb = cfg.dataset_config.mini_batch_config
    model = RcnnModel(
        mc, dataset.num_classes, clusters, rpn_fts_channels(mc),
        bev_z_max=float(dataset.bev_extents[1, 1]), mode=mode,
        cls_neg_iou_hi=mb.cls_iou_3d_thresholds.neg_iou_hi,
        cls_pos_iou_lo=mb.cls_iou_3d_thresholds.pos_iou_lo,
        reg_pos_iou_lo=mb.reg_iou_3d_thresholds.pos_iou_lo,
    )
    return model, lambda preds: rcnn_loss(preds, mc, group)


RCNN_BATCH_KEYS = (
    "rpn_roi", "rpn_iou", "rpn_gt", "rpn_pts", "rpn_intensity",
    "rpn_fg_mask", "rpn_fts", "image_input", "stereo_calib_p2",
)


def rcnn_forward(model: RcnnModel, batch: Dict[str, torch.Tensor], generators=None):
    """The RCNN on a batch of `RCNN_BATCH_KEYS` (the RCNN loader's)."""
    return model(batch["rpn_roi"], batch["rpn_pts"], batch["rpn_intensity"],
                 batch["rpn_fg_mask"], batch["rpn_fts"], batch["image_input"],
                 batch["stereo_calib_p2"], proposals_iou=batch["rpn_iou"],
                 proposals_gt=batch["rpn_gt"], generators=generators)


def make_rcnn_train_step(loss_fn: Callable) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                                        Dict[str, torch.Tensor]]:
    """The RCNN train step, the twin of `train_state.make_rpn_train_step`:
    train_step(state, batch) -> metrics (the three RCNN losses and
    "total_loss"); `batch` holds `RCNN_BATCH_KEYS` on the model's device."""

    def rcnn_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return train_step(state, lambda model, gens: rcnn_forward(model, batch, gens), loss_fn)[1]

    return rcnn_step


def make_batch_fn(cfg, dataset, model_kind: str, batch_size: int, group=None):
    """next_batch() -> a shuffled host batch (numpy) of the stage
    `model_kind` ("rpn" or "rcnn"), exactly the keys its train step reads
    (`RPN_BATCH_KEYS` / `RCNN_BATCH_KEYS`), at the config's point count and
    image size; the RCNN's with the config's `roi_per_sample` RoIs a frame,
    its feature files checked against the config's stage-1 width. With a
    data-parallel `group`, `batch_size` is the global batch and each rank
    loads its batch_size / world rows from `dataset`, its own shard
    (`parallel.distributed.shard_dataset_for_host`); the RCNN's handoff
    files are those of the shard's frames."""
    batch_size = rows_per_rank(batch_size, group)
    ic = cfg.model_config.input_config
    if model_kind == "rpn":
        keys = RPN_BATCH_KEYS
        kw = dict(model="rpn", pc_sample_pts=ic.pc_sample_pts)
    else:
        keys = RCNN_BATCH_KEYS
        kw = dict(model="rcnn", num_rois=cfg.dataset_config.mini_batch_config.roi_per_sample,
                  rpn_fts_channels=rpn_fts_channels(cfg.model_config))

    def next_batch():
        batch, _ = dataset.next_batch(batch_size, shuffle=True, img_w=ic.img_dims_w,
                                      img_h=ic.img_dims_h, **kw)
        return {k: batch[k] for k in keys}

    return next_batch


def build_detector(rpn_cfg, rcnn_cfg, dataset, conv_kernels: bool = False,
                   crop_kernel: bool = False) -> TwoStageDetector:
    """The test-mode RPN -> RCNN detector with the dataset's classes, mean
    sizes and far BEV extent, in eval mode, on the CPU."""
    return TwoStageDetector(
        rpn_cfg, rcnn_cfg, cluster_sizes_tuple(dataset),
        conv_kernels=conv_kernels, crop_kernel=crop_kernel,
        bev_z_max=float(dataset.bev_extents[1, 1]),
    ).eval()
