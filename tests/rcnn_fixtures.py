"""Shared pieces of the RCNN training tests, importing neither jax nor the
JAX package (tests/test_torch_cuda.py runs where only PyTorch is):

- `write_handoff`: a synthetic RPN -> RCNN handoff over a dataset's
  labelled frames, in the formats the RPN evaluator writes;
- `grads_agree`: the gradient tolerance of the RCNN's training tests.
  rtol 1e-3, and an atol of 1e-4 times the tensor's largest element (at
  least 1e-5), 5e-3 times it in the image branch, whose gradient reaches
  it only through the RoI crops' bilinear samples, their pixel cells fixed
  by each side's own float32 box projection: there float32 itself
  resolves no better (`python -m tests.test_torch_rcnn_training` prints
  the float64 measurements);
- `image_share_count`: how many elements only that wider share holds.
"""

from __future__ import annotations

import os

import numpy as np

from heterofusionrcnn_torch.configs import presets
from heterofusionrcnn_torch.datasets.kitti import labels as label_io
from heterofusionrcnn_torch.models.rpn import rpn_fts_channels
from heterofusionrcnn_torch.utils import np_box_ops

FTS = rpn_fts_channels(presets.rcnn_unittest().model_config)  # the stage-1 feature width


def write_handoff(ds, out_dir, seed=3, n_pts=512, n_fts=FTS):
    """RPN handoff files for every labelled frame of `ds`, in the formats
    `RpnEvaluator` writes: 24 proposals (8 jittered GT boxes, 16 boxes near
    GT centres), rows box + score at %.3f; their (n, m) 3D-IoU table
    against the GT boxes; [pts, intensity, fg, features] rows with half the
    points around the GT centres. Returns the three directories."""
    rng = np.random.default_rng(seed)
    dirs = [os.path.join(out_dir, d) for d in ("proposals", "ious", "feats")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    for sample in ds.sample_list:
        objs = label_io.filter_labels(label_io.read_labels(ds.label_dir, int(sample.name)),
                                      ds.classes)
        if not objs:
            continue
        gt = np.stack([label_io.object_label_to_box_3d(o) for o in objs])
        near = gt[rng.integers(0, len(gt), 8)] + rng.normal(0, 0.1, (8, 7))
        centers = gt[rng.integers(0, len(gt), 16)][:, :3]
        far = np.concatenate([centers + rng.normal(0, 1.5, (16, 3)),
                              np.abs(rng.normal([3.9, 1.6, 1.5], 0.3, (16, 3))),
                              rng.uniform(-np.pi, np.pi, (16, 1))], axis=1)
        rows = np.hstack([np.concatenate([near, far]), rng.random((24, 1))])
        path = os.path.join(dirs[0], sample.name + ".txt")
        np.savetxt(path, rows, fmt="%.3f")
        props = np.loadtxt(path)[:, :7]
        iou = np.array([[np_box_ops.box_3d_iou_pair(p, g)[0] for g in gt] for p in props])
        np.savetxt(os.path.join(dirs[1], sample.name + ".txt"), iou)
        around = gt[rng.integers(0, len(gt), n_pts // 2)][:, :3] + rng.normal(0, 1.0,
                                                                             (n_pts // 2, 3))
        spread = rng.uniform([-20, -2, 5], [20, 2, 50], (n_pts - n_pts // 2, 3))
        feats = np.hstack([np.concatenate([around, spread]), rng.random((n_pts, 1)),
                           (rng.random((n_pts, 1)) > 0.5), rng.normal(0, 1, (n_pts, n_fts))])
        np.save(os.path.join(dirs[2], sample.name + ".npy"), feats.astype(np.float32))
    return dirs


IMAGE_BRANCH = "img_vgg_pyr."


def _outside(got, want, share):
    atol = max(1e-5, share * float(want.abs().max()))
    return int(((got - want).abs() > atol + 1e-3 * want.abs()).sum())


def grads_agree(got, want, name):
    """Elementwise within rtol 1e-3 and atol 1e-4 (the image branch: 5e-3)
    x the tensor's largest |element|, at least 1e-5 (module docstring)."""
    return _outside(got, want, 5e-3 if name.startswith(IMAGE_BRANCH) else 1e-4) == 0


def image_share_count(grads, want):
    """How many elements of the image branch's gradients (name -> tensor)
    only its wider share holds: outside the 1e-4 one."""
    return sum(_outside(grads[n], w, 1e-4) for n, w in want.items()
               if n.startswith(IMAGE_BRANCH))
