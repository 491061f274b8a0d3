"""Shared experiment wiring of the port (heterofusionrcnn_tpu/
experiments/common.py): config resolution, the dataset, the test-mode
two-stage detector, the RPN in train or val mode with its loss, and the
RPN batch function. The RCNN's training loader is not ported yet."""

from __future__ import annotations

import os

import numpy as np

from heterofusionrcnn_torch.configs import config as config_lib
from heterofusionrcnn_torch.configs import presets
from heterofusionrcnn_torch.datasets.kitti.dataset import KittiDataset
from heterofusionrcnn_torch.inference import TwoStageDetector
from heterofusionrcnn_torch.models.rpn import RpnModel, rpn_loss
from heterofusionrcnn_torch.runtime.train_state import RPN_BATCH_KEYS

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


def build_model(cfg, dataset, mode: str):
    """The RPN of `cfg` in `mode` ("train", "val" or "test") with the
    dataset's classes and mean sizes, on the CPU, and its loss function
    (predictions -> (loss_dict, total)). An RCNN config raises: its
    training loader (`rcnn_sampling.py`) is not ported yet."""
    mc = cfg.model_config
    if mc.model_name != "rpn_model":
        raise NotImplementedError(
            f"{mc.model_name}: training the RCNN needs its loader (rcnn_sampling.py), "
            "which is not ported yet")
    model = RpnModel(mc, dataset.num_classes, cluster_sizes_tuple(dataset),
                     save_rpn_feature=False, mode=mode)
    return model, lambda preds: rpn_loss(preds, mc)


def make_batch_fn(cfg, dataset, batch_size: int):
    """next_batch() -> the RPN's host batch (numpy, exactly the
    `RPN_BATCH_KEYS` that its train step reads), shuffled, at the config's
    point count and image size."""
    ic = cfg.model_config.input_config

    def next_batch():
        batch, _ = dataset.next_batch(
            batch_size, shuffle=True, model="rpn", pc_sample_pts=ic.pc_sample_pts,
            img_w=ic.img_dims_w, img_h=ic.img_dims_h,
        )
        return {k: batch[k] for k in RPN_BATCH_KEYS}

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
