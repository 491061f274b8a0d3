"""KITTI dataset: sample lists, RPN and RCNN batch loading, collation.

Copy of heterofusionrcnn_tpu/datasets/kitti/dataset.py: the same sample
list, the same `np.random.default_rng(0)` call sequence and the same
batches. Images are read and resized by `image.py` instead of OpenCV;
point clouds by the numpy loader.

Parity target: hf/datasets/kitti/kitti_dataset.py. Differences kept from the
JAX package:
  - static shapes everywhere: GT boxes pad to a fixed `max_gt_boxes` (the
    reference pads to the max within a batch, kitti_dataset.py:843-883);
  - explicit np.random.Generator plumbed through loading/augmentation for
    deterministic per-host sharding (the reference used the global RNG, so
    multi-GPU workers sharded "by randomness" only — SURVEY.md §2.3);
  - `shard(host_index, host_count)` index-shards the sample list.

RCNN sample loading (the RPN's proposals, IoU tables and features read
back from `proposal_dir`, `proposal_iou_dir` and `rpn_feature_dir`, and the
RoI mini-batch sampling) lives in rcnn_sampling.py.
"""

from __future__ import annotations

import dataclasses
import itertools
import os

import numpy as np

from heterofusionrcnn_torch.configs import DatasetConfig
from heterofusionrcnn_torch.datasets.kitti import augmentation as aug
from heterofusionrcnn_torch.datasets.kitti import calib as calib_io
from heterofusionrcnn_torch.datasets.kitti import clusters as cluster_lib
from heterofusionrcnn_torch.datasets.kitti import image as image_io
from heterofusionrcnn_torch.datasets.kitti import labels as label_io
from heterofusionrcnn_torch.datasets.kitti import pointcloud as pc_lib
from heterofusionrcnn_torch.datasets.kitti.rcnn_sampling import load_rcnn_samples
from heterofusionrcnn_torch.utils.np_box_ops import points_in_box

# Batch-dict keys (parity with hf/datasets/kitti/constants.py naming).
KEY_LABEL_SEG = "label_seg"
KEY_LABEL_REG = "label_reg"
KEY_LABEL_BOXES_3D = "label_boxes_3d"
KEY_LABEL_NUM_BOXES = "label_num_boxes"
KEY_LABEL_CLASSES = "label_classes"
KEY_POINT_CLOUD = "point_cloud"
KEY_IMAGE_INPUT = "image_input"
KEY_STEREO_CALIB_P2 = "stereo_calib_p2"
KEY_SAMPLE_NAME = "sample_name"


@dataclasses.dataclass(frozen=True)
class Sample:
    name: str
    augs: tuple


class KittiDataset:
    """KITTI object dataset with RPN (and RCNN, via mixin use) batch loading."""

    def __init__(self, config: DatasetConfig, train_val_test: str = "train"):
        self.config = config
        self.train_val_test = train_val_test
        self.classes = list(config.classes)
        self.num_classes = len(self.classes)

        self.dataset_dir = os.path.expanduser(config.dataset_dir)
        self.data_split = config.data_split
        self.has_labels = config.has_labels

        split_dir = config.data_split_dir
        self._base_dir = os.path.join(self.dataset_dir, split_dir)
        self.image_dir = os.path.join(self._base_dir, "image_2")
        self.calib_dir = os.path.join(self._base_dir, "calib")
        self.velo_dir = os.path.join(self._base_dir, "velodyne")
        self.label_dir = os.path.join(self._base_dir, "label_2")
        self.planes_dir = os.path.join(self._base_dir, "planes")

        # The RPN's handoff files that the RCNN reads (set by the caller,
        # kitti_dataset.py:226-252).
        self.proposal_dir = None
        self.proposal_iou_dir = None
        self.rpn_feature_dir = None

        names = self.load_sample_names(self.data_split)

        # Augmentation combinatorics (kitti_dataset.py:116-131): every subset
        # of aug_list, applied over the full sample list.
        aug_list = list(config.aug_list) if train_val_test == "train" else []
        samples = []
        for k in range(len(aug_list) + 1):
            for combo in itertools.combinations(aug_list, k):
                for name in names:
                    samples.append(Sample(name, tuple(combo)))
        self.sample_list = np.asarray(samples, dtype=object)
        self.num_samples = len(self.sample_list)

        # Epoch state (kitti_dataset.py:107).
        self._index_in_epoch = 0
        self.epochs_completed = 0

        self.area_extents = np.reshape(config.area_extents, (3, 2))
        self.bev_extents = self.area_extents[[0, 2]]
        self.expand_gt_size = config.expand_gt_size
        self.max_gt_boxes = config.max_gt_boxes

        # Per-class mean sizes for the bin codec.
        cluster_names = self.load_sample_names(config.cluster_split)
        self.clusters, self.std_devs = cluster_lib.get_clusters(
            self.classes,
            list(config.num_clusters),
            self.label_dir,
            cluster_names,
            cache_dir=config.cluster_cache_dir,
            cluster_split=config.cluster_split,
        )

        # RCNN mini-batch config.
        mb = config.mini_batch_config
        self.cls_neg_iou_range = [
            mb.cls_iou_3d_thresholds.neg_iou_lo,
            mb.cls_iou_3d_thresholds.neg_iou_hi,
        ]
        self.cls_pos_iou_range = [
            mb.cls_iou_3d_thresholds.pos_iou_lo,
            mb.cls_iou_3d_thresholds.pos_iou_hi,
        ]
        self.reg_neg_iou_range = [
            mb.reg_iou_3d_thresholds.neg_iou_lo,
            mb.reg_iou_3d_thresholds.neg_iou_hi,
        ]
        self.reg_pos_iou_range = [
            mb.reg_iou_3d_thresholds.pos_iou_lo,
            mb.reg_iou_3d_thresholds.pos_iou_hi,
        ]
        self.roi_per_sample = mb.roi_per_sample
        self.fg_ratio = mb.fg_ratio
        self.hard_bg_ratio = mb.hard_bg_ratio

        self._rng = np.random.default_rng(0)

    # ------------------------------------------------------------------ #
    # Sample list management
    # ------------------------------------------------------------------ #

    def load_sample_names(self, data_split: str):
        path = os.path.join(self.dataset_dir, data_split + ".txt")
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]

    def seed(self, seed: int) -> None:
        """Reset the pipeline RNG (deterministic epochs/sharding)."""
        self._rng = np.random.default_rng(seed)

    def shard(self, host_index: int, host_count: int) -> None:
        """Deterministically index-shard the sample list across hosts
        (replaces the reference's independent random shuffles per rank)."""
        self.sample_list = self.sample_list[host_index::host_count]
        self.num_samples = len(self.sample_list)

    def _shuffle_samples(self) -> None:
        perm = self._rng.permutation(self.num_samples)
        self.sample_list = self.sample_list[perm]

    def get_rgb_image_path(self, sample_name: str) -> str:
        return os.path.join(self.image_dir, sample_name + ".png")

    # ------------------------------------------------------------------ #
    # RPN sample loading
    # ------------------------------------------------------------------ #

    def load_rpn_samples(
        self,
        indices,
        pc_sample_pts: int = 16384,
        img_w: int = 1200,
        img_h: int = 360,
    ):
        """Load per-sample RPN input dicts (kitti_dataset.py:291-414)."""
        sample_dicts = []
        for sample_idx in indices:
            sample = self.sample_list[sample_idx]

            label_boxes_3d = label_classes = None
            if self.has_labels:
                obj_labels = label_io.read_labels(self.label_dir, int(sample.name))
                obj_labels = label_io.filter_labels(obj_labels, self.classes)
                if len(obj_labels) <= 0:
                    continue  # skip label-less samples in train/val
                label_boxes_3d = np.stack(
                    [label_io.object_label_to_box_3d(o) for o in obj_labels]
                )
                label_classes = np.array(
                    [
                        label_io.class_str_to_index(o.type, self.classes)
                        for o in obj_labels
                    ],
                    np.int32,
                )

            rgb_image = image_io.read_png(self.get_rgb_image_path(sample.name))
            image_shape = rgb_image.shape[:2]
            image_input = rgb_image

            p2 = calib_io.read_calibration(self.calib_dir, int(sample.name)).p2.copy()

            pc4 = pc_lib.get_lidar_point_cloud(
                int(sample.name),
                self.calib_dir,
                self.velo_dir,
                im_size=[image_shape[1], image_shape[0]],
            )
            pts_rect, intensity = pc4[:, :3], pc4[:, 3]

            sampled_pts, sampled_intensity = pc_lib.depth_stratified_sample(
                pts_rect, intensity, pc_sample_pts, self._rng
            )
            # Intensity translated to [-0.5, 0.5] (kitti_dataset.py:368-371).
            sampled_pc = np.hstack(
                [sampled_pts, sampled_intensity - 0.5]
            ).astype(np.float32)

            if self.has_labels:
                if aug.AUG_FLIPPING in sample.augs:
                    image_input = aug.flip_image(image_input)
                    sampled_pc = aug.flip_points(sampled_pc)
                    p2 = calib_io.flip_calib_p2(p2, image_shape)
                    label_boxes_3d = aug.flip_boxes_3d(label_boxes_3d)
                if aug.AUG_PCA_JITTER in sample.augs:
                    image_input = np.ascontiguousarray(image_input)
                    image_input = aug.apply_pca_jitter(image_input, self._rng)

                label_seg, label_reg = self.generate_rpn_training_labels(
                    sampled_pc[:, :3], label_boxes_3d, label_classes
                )
            else:
                label_boxes_3d = np.zeros((1, 7), np.float32)
                label_classes = np.zeros(1, np.float32)
                label_seg = np.zeros(pc_sample_pts, np.float32)
                label_reg = np.zeros((pc_sample_pts, 7), np.float32)

            image_resized = image_io.resize_bilinear(image_input, img_w, img_h)
            p2[0, :] *= img_w / image_input.shape[1]
            p2[1, :] *= img_h / image_input.shape[0]

            sample_dicts.append(
                {
                    KEY_LABEL_SEG: label_seg.astype(np.float32),
                    KEY_LABEL_REG: label_reg.astype(np.float32),
                    KEY_LABEL_BOXES_3D: label_boxes_3d.astype(np.float32),
                    KEY_LABEL_CLASSES: np.asarray(
                        label_classes, np.float32
                    ),
                    KEY_POINT_CLOUD: sampled_pc,
                    KEY_IMAGE_INPUT: image_resized.astype(np.float32),
                    KEY_STEREO_CALIB_P2: p2.astype(np.float32),
                    KEY_SAMPLE_NAME: sample.name,
                }
            )
        return sample_dicts

    def generate_rpn_training_labels(
        self, pts_rect: np.ndarray, gt_boxes3d: np.ndarray, gt_classes: np.ndarray
    ):
        """Per-point class + box-regression labels with an expanded-box ignore
        ring (kitti_dataset.py:416-440), vectorized over boxes.

        Returns:
          cls_label: (N,) float — 0 bg, class index fg, -1 ignore.
          reg_label: (N, 7) box_3d of the owning GT box.
        """
        n = pts_rect.shape[0]
        cls_label = np.zeros(n, np.int32)
        reg_label = np.zeros((n, 7), np.float32)

        extended = gt_boxes3d.copy()
        extended[:, 3:6] += self.expand_gt_size * 2
        extended[:, 1] += self.expand_gt_size

        for k in range(gt_boxes3d.shape[0]):
            fg = points_in_box(pts_rect, gt_boxes3d[k])
            cls_label[fg] = gt_classes[k]
            reg_label[fg] = gt_boxes3d[k]
            enlarged = points_in_box(pts_rect, extended[k])
            ignore = np.logical_xor(fg, enlarged)
            cls_label[ignore] = -1

        return cls_label.astype(np.float32), reg_label

    # ------------------------------------------------------------------ #
    # Batching
    # ------------------------------------------------------------------ #

    def load_samples(self, indices, model: str = "rpn", **kwargs):
        if model == "rpn":
            return self.load_rpn_samples(indices, **kwargs)
        if model == "rcnn":
            return load_rcnn_samples(self, indices, **kwargs)
        raise ValueError(f"unknown model {model}")

    def next_batch(self, batch_size: int, shuffle: bool = True, **kwargs):
        """Epoch-tracking batch iterator (kitti_dataset.py:781-841).

        Returns:
          (batch_data dict of stacked arrays, list of sample names).
        """
        samples_in_batch = []
        if self.epochs_completed == 0 and self._index_in_epoch == 0 and shuffle:
            self._shuffle_samples()

        while len(samples_in_batch) < batch_size:
            remain = batch_size - len(samples_in_batch)
            start = self._index_in_epoch
            if start + remain >= self.num_samples:
                self.epochs_completed += 1
                samples_in_batch.extend(
                    self.load_samples(np.arange(start, self.num_samples), **kwargs)
                )
                if shuffle:
                    self._shuffle_samples()
                self._index_in_epoch = 0
                # NOTE: unlike the reference we don't wrap into the next epoch
                # mid-batch when some samples were skipped (no labels) — we
                # just keep pulling from the next epoch below.
                if len(samples_in_batch) < batch_size and self.num_samples == 0:
                    raise RuntimeError("empty dataset")
            else:
                self._index_in_epoch += remain
                samples_in_batch.extend(
                    self.load_samples(np.arange(start, start + remain), **kwargs)
                )

        samples_in_batch = samples_in_batch[:batch_size]
        return self.collate_batch(samples_in_batch)

    def collate_batch(self, samples):
        """Stack sample dicts; GT boxes pad to the static max_gt_boxes with a
        count array (reference pads to batch max, kitti_dataset.py:843-883)."""
        batch_size = len(samples)
        batch_data = {}
        sample_names = [s[KEY_SAMPLE_NAME] for s in samples]

        for key in samples[0]:
            if key == KEY_SAMPLE_NAME:
                continue
            if key == KEY_LABEL_BOXES_3D:
                padded = np.zeros(
                    (batch_size, self.max_gt_boxes, 7), np.float32
                )
                counts = np.zeros(batch_size, np.int32)
                for i, s in enumerate(samples):
                    boxes = s[key][: self.max_gt_boxes]
                    padded[i, : len(boxes)] = boxes
                    counts[i] = len(boxes)
                batch_data[key] = padded
                batch_data[KEY_LABEL_NUM_BOXES] = counts
                continue
            if key == KEY_LABEL_CLASSES:
                # Same max-GT padding as the boxes (the reference passes real
                # per-GT classes into compute_recall_iou, evaluator.py:299).
                padded = np.zeros((batch_size, self.max_gt_boxes), np.float32)
                for i, s in enumerate(samples):
                    cls = s[key][: self.max_gt_boxes]
                    padded[i, : len(cls)] = cls
                batch_data[key] = padded
                continue
            batch_data[key] = np.stack([s[key] for s in samples])

        return batch_data, sample_names
