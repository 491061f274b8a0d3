"""RCNN sample loading + RoI mini-batch sampling.

Copy of heterofusionrcnn_tpu/datasets/kitti/rcnn_sampling.py (parity with
hf/datasets/kitti/kitti_dataset.py:442-774): reads the RPN stage's saved
proposals / proposal-IoU / per-point feature files, and in train mode
samples a fixed `roi_per_sample` mini-batch (fg / easy-bg / hard-bg split by
3D IoU thresholds) with IoU-retry noise augmentation of fg RoIs.

Host-side numpy with an explicit RNG (dataset._rng), drawn in the JAX
file's order, so one seed gives the same mini-batch on both sides. Images
are read and resized by `image.py` instead of OpenCV (the same pixels).
"""

from __future__ import annotations

import numpy as np

from heterofusionrcnn_torch.datasets.kitti import augmentation as aug
from heterofusionrcnn_torch.datasets.kitti import calib as calib_io
from heterofusionrcnn_torch.datasets.kitti import image as image_io
from heterofusionrcnn_torch.datasets.kitti import labels as label_io
from heterofusionrcnn_torch.utils.np_box_ops import box_3d_iou_pair, box_3d_iou_pairs

KEY_RPN_PTS = "rpn_pts"
KEY_RPN_INTENSITY = "rpn_intensity"
KEY_RPN_FG_MASK = "rpn_fg_mask"
KEY_RPN_FTS = "rpn_fts"
KEY_RPN_ROI = "rpn_roi"
KEY_RPN_IOU = "rpn_iou"
KEY_RPN_GT = "rpn_gt"

# random_aug_box3d 'multiple' ranges (kitti_dataset.py:735-747):
# [pos_range, hwl_range, angle_range, mean_iou].
_MULTI_RANGES = [
    [0.2, 0.1, np.pi / 12],
    [0.3, 0.15, np.pi / 12],
    [0.5, 0.15, np.pi / 9],
    [0.8, 0.15, np.pi / 6],
    [1.0, 0.15, np.pi / 3],
]


def get_proposal(ds, sample_name):
    """(n, 7) proposals from the RPN's saved txt (rows of 8: box + score)."""
    path = f"{ds.proposal_dir}/{sample_name}.txt"
    return np.loadtxt(path).reshape(-1, 8)[:, :7]


def get_rpn_features(ds, sample_name, rpn_fts_channels=None):
    """npy rows [x, y, z, intensity, fg_mask, features...]
    (parity with kitti_dataset.get_rpn_features :241-249); with
    `rpn_fts_channels`, a file of another feature width raises."""
    path = f"{ds.rpn_feature_dir}/{sample_name}.npy"
    arr = np.load(path)
    if rpn_fts_channels is not None and arr.shape[1] != rpn_fts_channels + 5:
        raise ValueError(
            f"{path}: rows of {arr.shape[1]} values, but this RCNN takes "
            f"{rpn_fts_channels} feature channels + 5 (points, intensity, fg mask): "
            "the file comes from an RPN of another width")
    return arr[:, 0:3], arr[:, 3], arr[:, 4], arr[:, 5:]


def get_proposal_iou(ds, sample_name):
    return np.loadtxt(f"{ds.proposal_iou_dir}/{sample_name}.txt")


def random_aug_box3d(rng, box3d, method):
    """Random shift/scale/rotation of one RoI (kitti_dataset.py:717-774)."""
    if method == "single":
        pos_shift = rng.random(3) - 0.5
        hwl_scale = (rng.random(3) - 0.5) / (0.5 / 0.15) + 1.0
        angle_rot = (rng.random(1) - 0.5) / (0.5 / (np.pi / 12))
        return np.concatenate(
            [box3d[0:3] + pos_shift, box3d[3:6] * hwl_scale, box3d[6:7] + angle_rot]
        )
    elif method == "multiple":
        idx = rng.integers(len(_MULTI_RANGES))
        pos_r, hwl_r, ang_r = _MULTI_RANGES[idx]
        pos_shift = ((rng.random(3) - 0.5) / 0.5) * pos_r
        hwl_scale = ((rng.random(3) - 0.5) / 0.5) * hwl_r + 1.0
        angle_rot = ((rng.random(1) - 0.5) / 0.5) * ang_r
        return np.concatenate(
            [box3d[0:3] + pos_shift, box3d[3:6] * hwl_scale, box3d[6:7] + angle_rot]
        )
    elif method == "normal":
        shifts = np.array(
            [
                rng.normal(0, 0.3),
                rng.normal(0, 0.2),
                rng.normal(0, 0.3),
                rng.normal(0, 0.25),
                rng.normal(0, 0.15),
                rng.normal(0, 0.5),
            ]
        )
        ry_shift = ((rng.random() - 0.5) / 0.5) * np.pi / 12
        out = box3d.copy()
        out[:6] = out[:6] + shifts
        out[6] = out[6] + ry_shift
        return out
    raise NotImplementedError(method)


def random_aug_boxes3d(rng, boxes3d, method, draws):
    """Batched random_aug_box3d: (n, 7) boxes x `draws` jitters -> (n, draws, 7)
    with the same per-draw distribution (kitti_dataset.py:717-774)."""
    n = len(boxes3d)
    base = boxes3d[:, None, :]
    if method == "single":
        pos_shift = rng.random((n, draws, 3)) - 0.5
        hwl_scale = (rng.random((n, draws, 3)) - 0.5) / (0.5 / 0.15) + 1.0
        angle_rot = (rng.random((n, draws, 1)) - 0.5) / (0.5 / (np.pi / 12))
    elif method == "multiple":
        ranges = np.asarray(_MULTI_RANGES)
        pick = ranges[rng.integers(len(_MULTI_RANGES), size=(n, draws))]
        pos_shift = ((rng.random((n, draws, 3)) - 0.5) / 0.5) * pick[..., 0:1]
        hwl_scale = ((rng.random((n, draws, 3)) - 0.5) / 0.5) * pick[..., 1:2] + 1.0
        angle_rot = ((rng.random((n, draws, 1)) - 0.5) / 0.5) * pick[..., 2:3]
    elif method == "normal":
        stds = np.array([0.3, 0.2, 0.3, 0.25, 0.15, 0.5])
        shifts = rng.normal(0.0, stds, (n, draws, 6))
        ry_shift = ((rng.random((n, draws, 1)) - 0.5) / 0.5) * np.pi / 12
        return np.concatenate([base[..., :6] + shifts, base[..., 6:7] + ry_shift], -1)
    else:
        raise NotImplementedError(method)
    return np.concatenate(
        [base[..., 0:3] + pos_shift, base[..., 3:6] * hwl_scale,
         base[..., 6:7] + angle_rot],
        axis=-1,
    )


def aug_roi_by_noise(ds, roi_boxes3d, gt_boxes3d, aug_times=10):
    """Jitter each RoI until it still has IoU >= pos_thresh with its GT
    (kitti_dataset.py:687-715); returns jittered rois + their 3D IoUs.

    Vectorized over RoIs AND retries: the reference's lazy retry loop draws
    candidates one at a time until the first success; here all `aug_times`
    candidates are drawn up-front (iid, identical per-draw law), pair IoUs
    come from one batched polygon clip, and the FIRST passing candidate is
    selected (the last one when none pass — the loop keeps its final draw).
    The joint law of (selected box, iou) is unchanged; only the RNG stream
    consumption differs (`aug_roi_by_noise_loop` is the loop form): 64 RoIs x
    10 retries x a scalar polygon clip per RCNN train sample, batched.
    """
    rng = ds._rng
    pos_thresh = min(ds.reg_pos_iou_range[0], ds.cls_pos_iou_range[0])
    n = len(roi_boxes3d)
    if n == 0:
        return roi_boxes3d.copy(), np.zeros(0, np.float32)
    t = aug_times
    keep_orig = rng.random((n, t)) < 0.2
    cands = random_aug_boxes3d(rng, roi_boxes3d, ds.config.aug_roi_method, t)
    cands = np.where(keep_orig[..., None], roi_boxes3d[:, None, :], cands)
    flat_iou3d, _ = box_3d_iou_pairs(
        cands.reshape(-1, 7), np.repeat(gt_boxes3d, t, axis=0)
    )
    ious = flat_iou3d.reshape(n, t)
    passing = ious >= pos_thresh
    pick = np.where(passing.any(axis=1), np.argmax(passing, axis=1), t - 1)
    rows = np.arange(n)
    return (
        cands[rows, pick].astype(roi_boxes3d.dtype),
        ious[rows, pick].astype(np.float32),
    )


def aug_roi_by_noise_loop(ds, roi_boxes3d, gt_boxes3d, aug_times=10):
    """Reference-shaped per-RoI retry loop (kitti_dataset.py:687-715), the
    oracle of the vectorized version's distribution."""
    rng = ds._rng
    pos_thresh = min(ds.reg_pos_iou_range[0], ds.cls_pos_iou_range[0])
    out = roi_boxes3d.copy()
    ious = np.zeros(len(roi_boxes3d), np.float32)
    for k in range(len(roi_boxes3d)):
        temp_iou = 0.0
        cnt = 0
        aug_box3d = roi_boxes3d[k]
        while temp_iou < pos_thresh and cnt < aug_times:
            if rng.random() < 0.2:
                aug_box3d = roi_boxes3d[k]
            else:
                aug_box3d = random_aug_box3d(
                    rng, roi_boxes3d[k], ds.config.aug_roi_method
                )
            temp_iou, _ = box_3d_iou_pair(aug_box3d, gt_boxes3d[k])
            cnt += 1
        out[k] = aug_box3d
        ious[k] = temp_iou
    return out, ious


def sample_bg_inds(ds, hard_bg_inds, easy_bg_inds, num):
    """fg/hard-bg ratio split (kitti_dataset.py:651-685)."""
    rng = ds._rng
    if hard_bg_inds.size > 0 and easy_bg_inds.size > 0:
        hard_num = int(num * ds.hard_bg_ratio)
        easy_num = num - hard_num
        hard = hard_bg_inds[
            np.floor(rng.random(hard_num) * hard_bg_inds.size).astype(np.int32)
        ]
        easy = easy_bg_inds[
            np.floor(rng.random(easy_num) * easy_bg_inds.size).astype(np.int32)
        ]
        return np.concatenate([hard, easy])
    if hard_bg_inds.size > 0:
        return hard_bg_inds[
            np.floor(rng.random(num) * hard_bg_inds.size).astype(np.int32)
        ]
    if easy_bg_inds.size > 0:
        return easy_bg_inds[
            np.floor(rng.random(num) * easy_bg_inds.size).astype(np.int32)
        ]
    raise NotImplementedError("no background rois available")


def sample_rois_for_rcnn_training(ds, roi_boxes3d, iou3d, gt_info):
    """fg/easy-bg/hard-bg mini-batch sampling (kitti_dataset.py:545-649).

    Args:
      roi_boxes3d: (m, 7); iou3d: (m, n_gt); gt_info: (n_gt, 8) box+cls.
    Returns:
      rois (N, 7), iou_of_rois (N,), gt_of_rois (N, 8) with N=roi_per_sample.
    """
    rng = ds._rng
    max_overlaps = iou3d.max(axis=1)
    gt_assignment = iou3d.argmax(axis=1)
    max_iou_of_gt = iou3d.max(axis=0)
    roi_assignment = iou3d.argmax(axis=0)[max_iou_of_gt > 0].reshape(-1)

    fg_per_image = int(np.round(ds.fg_ratio * ds.roi_per_sample))
    fg_thresh = min(ds.reg_pos_iou_range[0], ds.cls_pos_iou_range[0])
    fg_inds = np.flatnonzero(max_overlaps >= fg_thresh)
    # The best RoI of every GT counts as fg even below threshold.
    fg_inds = np.concatenate([fg_inds, roi_assignment])

    easy_bg_inds = np.flatnonzero(max_overlaps < ds.cls_neg_iou_range[0])
    hard_bg_inds = np.flatnonzero(
        (max_overlaps < ds.cls_neg_iou_range[1])
        & (max_overlaps >= ds.cls_neg_iou_range[0])
    )

    fg_num = fg_inds.size
    bg_num = easy_bg_inds.size + hard_bg_inds.size

    if fg_num > 0 and bg_num > 0:
        fg_this = min(fg_per_image, fg_num)
        fg_inds = fg_inds[rng.permutation(fg_num)[:fg_this]]
        bg_this = ds.roi_per_sample - fg_this
        bg_inds = sample_bg_inds(ds, hard_bg_inds, easy_bg_inds, bg_this)
    elif fg_num > 0:
        pick = np.floor(rng.random(ds.roi_per_sample) * fg_num).astype(np.int32)
        fg_inds = fg_inds[pick]
        fg_this, bg_this = ds.roi_per_sample, 0
    elif bg_num > 0:
        bg_this, fg_this = ds.roi_per_sample, 0
        bg_inds = sample_bg_inds(ds, hard_bg_inds, easy_bg_inds, bg_this)
    else:
        raise RuntimeError("no rois to sample")

    roi_list, iou_list, gt_list = [], [], []
    if fg_this > 0:
        fg_rois_src = roi_boxes3d[fg_inds].copy()
        gt_of_fg = gt_info[gt_assignment[fg_inds]]
        if ds.config.aug_roi_method:
            fg_rois, fg_iou = aug_roi_by_noise(ds, fg_rois_src, gt_of_fg[:, :7], 10)
        else:
            fg_rois, fg_iou = fg_rois_src, max_overlaps[fg_inds]
        roi_list.append(fg_rois)
        iou_list.append(fg_iou)
        gt_list.append(gt_of_fg)
    if bg_this > 0:
        bg_rois_src = roi_boxes3d[bg_inds].copy()
        gt_of_bg = gt_info[gt_assignment[bg_inds]]
        if ds.config.aug_roi_method:
            bg_rois, bg_iou = aug_roi_by_noise(ds, bg_rois_src, gt_of_bg[:, :7], 1)
        else:
            bg_rois, bg_iou = bg_rois_src, max_overlaps[bg_inds]
        roi_list.append(bg_rois)
        iou_list.append(bg_iou)
        gt_list.append(gt_of_bg)

    return (
        np.concatenate(roi_list).astype(np.float32),
        np.concatenate(iou_list).astype(np.float32),
        np.concatenate(gt_list).astype(np.float32),
    )


def load_rcnn_samples(ds, indices, img_w=1200, img_h=360, num_rois=None,
                      rpn_fts_channels=None):
    """Load per-sample RCNN input dicts (kitti_dataset.py:442-543).

    In val/test mode the RoI count equals the saved proposal count; pass
    `num_rois` to pad/trim to a static size (batches of equal shapes) —
    padded RoIs replicate the first proposal and are marked by iou 0 / gt
    cls 0. With `rpn_fts_channels` (the RCNN's stage-1 feature width), a
    feature file of another width raises ValueError.
    """
    sample_dicts = []
    for sample_idx in indices:
        sample = ds.sample_list[sample_idx]

        gt_boxes3d = gt_classes = iou3d = None
        if ds.has_labels:
            obj_labels = label_io.read_labels(ds.label_dir, int(sample.name))
            obj_labels = label_io.filter_labels(obj_labels, ds.classes)
            if len(obj_labels) <= 0:
                continue
            gt_boxes3d = np.stack(
                [label_io.object_label_to_box_3d(o) for o in obj_labels]
            )
            gt_classes = np.array(
                [label_io.class_str_to_index(o.type, ds.classes) for o in obj_labels],
                np.int32,
            )
            iou3d = get_proposal_iou(ds, sample.name).reshape(-1, len(gt_boxes3d))

        rgb_image = image_io.read_png(ds.get_rgb_image_path(sample.name))
        image_shape = rgb_image.shape[:2]
        image_input = rgb_image

        p2 = calib_io.read_calibration(ds.calib_dir, int(sample.name)).p2.copy()

        rpn_pts, rpn_intensity, rpn_fg_mask, rpn_fts = get_rpn_features(
            ds, sample.name, rpn_fts_channels
        )
        roi_boxes3d = get_proposal(ds, sample.name)

        if ds.train_val_test == "train":
            if aug.AUG_FLIPPING in sample.augs:
                image_input = aug.flip_image(image_input)
                rpn_pts = aug.flip_points(rpn_pts)
                p2 = calib_io.flip_calib_p2(p2, image_shape)
                gt_boxes3d = aug.flip_boxes_3d(gt_boxes3d)
                roi_boxes3d = aug.flip_boxes_3d(roi_boxes3d)
            if aug.AUG_PCA_JITTER in sample.augs:
                image_input = np.ascontiguousarray(image_input)
                image_input = aug.apply_pca_jitter(image_input, ds._rng)

            gt_info = np.hstack([gt_boxes3d, gt_classes.reshape(-1, 1)])
            rois, iou_of_rois, gt_of_rois = sample_rois_for_rcnn_training(
                ds, roi_boxes3d, iou3d, gt_info
            )
        elif ds.train_val_test == "val":
            rois = roi_boxes3d
            iou_of_rois = iou3d.max(axis=1)
            gt_info = np.hstack([gt_boxes3d, gt_classes.reshape(-1, 1)])
            gt_of_rois = gt_info[iou3d.argmax(axis=1)]
        elif ds.train_val_test == "test":
            rois = roi_boxes3d
            iou_of_rois = np.zeros(len(rois), np.float32)
            gt_of_rois = np.zeros((len(rois), 8), np.float32)
        else:
            raise ValueError(ds.train_val_test)

        if num_rois is not None:
            rois, iou_of_rois, gt_of_rois = _pad_rois(
                rois, iou_of_rois, gt_of_rois, num_rois
            )

        image_resized = image_io.resize_bilinear(image_input, img_w, img_h)
        p2[0, :] *= img_w / image_input.shape[1]
        p2[1, :] *= img_h / image_input.shape[0]

        sample_dicts.append(
            {
                KEY_RPN_PTS: rpn_pts.astype(np.float32),
                KEY_RPN_INTENSITY: rpn_intensity.astype(np.float32),
                KEY_RPN_FG_MASK: rpn_fg_mask.astype(np.float32),
                KEY_RPN_FTS: rpn_fts.astype(np.float32),
                KEY_RPN_ROI: rois.astype(np.float32),
                KEY_RPN_IOU: iou_of_rois.astype(np.float32),
                KEY_RPN_GT: gt_of_rois.astype(np.float32),
                "image_input": image_resized.astype(np.float32),
                "stereo_calib_p2": p2.astype(np.float32),
                "sample_name": sample.name,
            }
        )
    return sample_dicts


def _pad_rois(rois, ious, gts, num_rois):
    """Pad (replicating row 0 with zeroed iou/gt) or trim to num_rois."""
    n = len(rois)
    if n >= num_rois:
        return rois[:num_rois], ious[:num_rois], gts[:num_rois]
    pad = num_rois - n
    rois = np.concatenate([rois, np.tile(rois[:1], (pad, 1))])
    ious = np.concatenate([ious, np.zeros(pad, ious.dtype)])
    gts = np.concatenate([gts, np.zeros((pad, gts.shape[1]), gts.dtype)])
    return rois, ious, gts
