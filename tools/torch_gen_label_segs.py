"""Per-point segmentation / regression labels for the PyTorch port
(counterpart of tools/gen_label_segs.py): one .npy a frame, rows
[cls, x, y, z, l, w, h, ry] for every point of the frame's full
(unsampled) frustum cloud, cls -1 on the ring that the box grown by
`--expand_gt_size` adds. The port's dataset labels points online; this
cache mirrors the reference's offline preprocessing.

The image size comes from the PNG header (`datasets.kitti.image.png_size`,
no OpenCV) and the points from the native loader; a pool of `--workers`
processes started by `spawn` labels the frames.

    python tools/torch_gen_label_segs.py --dataset_dir /data/Kitti/object \
        --data_split train --out_dir /data/label_segs --workers 8
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import multiprocessing as mp

import numpy as np

from heterofusionrcnn_torch.datasets.kitti import image as image_io
from heterofusionrcnn_torch.datasets.kitti import labels as label_io
from heterofusionrcnn_torch.datasets.kitti import pointcloud as pc_lib
from heterofusionrcnn_torch.datasets.kitti.native_loader import ensure_built
from heterofusionrcnn_torch.utils.np_box_ops import points_in_box


def _process_sample(job):
    """Labels one frame into <out_dir>/<name>.npy (kept if it exists);
    returns (name, foreground points written)."""
    dataset_dir, out_dir, name, classes, expand = job
    base = os.path.join(dataset_dir, "training")
    out_path = os.path.join(out_dir, name + ".npy")
    if os.path.exists(out_path):
        return name, 0
    w, h = image_io.png_size(os.path.join(base, "image_2", name + ".png"))
    pc = pc_lib.get_lidar_point_cloud(int(name), os.path.join(base, "calib"),
                                      os.path.join(base, "velodyne"), im_size=[w, h])
    pts = pc[:, :3]
    objs = label_io.filter_labels(
        label_io.read_labels(os.path.join(base, "label_2"), int(name)), classes)
    cls_label = np.zeros(len(pts), np.float32)
    reg_label = np.zeros((len(pts), 7), np.float32)
    for obj in objs:
        box = label_io.object_label_to_box_3d(obj)
        fg = points_in_box(pts, box)
        cls_label[fg] = label_io.class_str_to_index(obj.type, classes)
        reg_label[fg] = box
        expanded = box.copy()
        expanded[3:6] += expand * 2
        expanded[1] += expand
        cls_label[np.logical_xor(fg, points_in_box(pts, expanded))] = -1
    np.save(out_path, np.hstack([cls_label[:, None], reg_label]))
    return name, int((cls_label > 0).sum())


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dataset_dir", required=True)
    parser.add_argument("--data_split", default="train")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--classes", nargs="*", default=["Car", "Pedestrian", "Cyclist"])
    parser.add_argument("--expand_gt_size", type=float, default=0.2)
    parser.add_argument("--workers", type=int, default=os.cpu_count())
    return parser.parse_args(argv)


def main(argv=None):
    """Labels every frame of the split; returns {name: foreground points}
    (0 for a frame whose file existed)."""
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.dataset_dir, args.data_split + ".txt")) as f:
        names = [line.strip() for line in f if line.strip()]
    jobs = [(args.dataset_dir, args.out_dir, n, tuple(args.classes), args.expand_gt_size)
            for n in names]
    ensure_built()  # once here, not in every worker at once
    done = {}
    with mp.get_context("spawn").Pool(args.workers) as pool:
        for name, fg in pool.imap_unordered(_process_sample, jobs):
            print(f"{name}: {fg} fg points")
            done[name] = fg
    return done


if __name__ == "__main__":
    main()
