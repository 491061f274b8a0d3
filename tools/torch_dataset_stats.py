"""Dataset statistics on the PyTorch port's data layer (counterpart of
tools/dataset_stats.py, with its subcommands, flags, files and printed
lines).

Two subcommands:
  histograms — per-class GT histograms (centroid x/y/z, l/w/h, orientation,
               points per frame) saved as one PNG per class + a JSON with
               the raw summary stats (needs matplotlib).
  mean       — dataset RGB channel means (the constant baked into
               img extractors' preprocess_image).

    python tools/torch_dataset_stats.py histograms --dataset_dir \
        tests/fixtures/kitti --data_split trainval --out_dir /tmp/stats
    python tools/torch_dataset_stats.py mean --dataset_dir tests/fixtures/kitti

Frames come through `heterofusionrcnn_torch.datasets.kitti`; images through
its PNG reader (`image.read_png`, RGB), so no OpenCV is needed. Host only:
nothing here runs on the card.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json

import numpy as np

from heterofusionrcnn_torch.configs import DatasetConfig
from heterofusionrcnn_torch.datasets.kitti import labels as label_io
from heterofusionrcnn_torch.datasets.kitti import pointcloud as pc_lib
from heterofusionrcnn_torch.datasets.kitti.dataset import KittiDataset
from heterofusionrcnn_torch.datasets.kitti.image import read_png

HIST_BINS = {"x": 51, "y": 51, "z": 51, "l": 21, "w": 21, "h": 21, "ry": 65}


def dataset_summary(ds: KittiDataset, classes):
    """The JSON summary of `ds`'s frames: the sample count, points per frame
    and each class's count and per-field mean and std; and, per class, the
    label fields as arrays and the points per frame (the histograms' data)."""
    per_class = {c: {k: [] for k in HIST_BINS} for c in classes}
    pts_per_frame = []
    for name in sorted({s.name for s in ds.sample_list}):
        objs = label_io.read_labels(ds.label_dir, int(name))
        for c in classes:
            d = per_class[c]
            for o in label_io.filter_labels(objs, [c]):
                d["x"].append(o.t[0]); d["y"].append(o.t[1])
                d["z"].append(o.t[2])
                d["l"].append(o.l); d["w"].append(o.w); d["h"].append(o.h)
                d["ry"].append(o.ry)
        pc = pc_lib.get_lidar_point_cloud(int(name), ds.calib_dir, ds.velo_dir)
        pts_per_frame.append(len(pc))

    summary = {"num_samples": ds.num_samples,
               "points_per_frame": {
                   "mean": float(np.mean(pts_per_frame)),
                   "min": int(np.min(pts_per_frame)),
                   "max": int(np.max(pts_per_frame))}}
    fields = {}
    for c in classes:
        d = {k: np.asarray(v) for k, v in per_class[c].items()}
        n = len(d["x"])
        summary[c] = {"count": n}
        if n == 0:
            continue
        summary[c].update(
            {k: {"mean": float(v.mean()), "std": float(v.std())} for k, v in d.items()})
        fields[c] = d
    return summary, fields, pts_per_frame


def _pyplot():
    """matplotlib's pyplot on the Agg backend; ImportError (naming
    matplotlib) where it is not installed, as on the card's machine."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def cmd_histograms(args):
    plt = _pyplot()
    cfg = DatasetConfig(dataset_dir=args.dataset_dir)
    ds = KittiDataset(cfg, args.data_split)
    os.makedirs(args.out_dir, exist_ok=True)
    classes = args.classes.split(",") if args.classes else ds.classes
    summary, fields, pts_per_frame = dataset_summary(ds, classes)
    for c, d in fields.items():
        n = len(d["x"])
        fig, axes = plt.subplots(2, 4, figsize=(16, 7))
        for ax, (k, v) in zip(axes.ravel(), d.items()):
            ax.hist(v, bins=HIST_BINS[k])
            ax.set_title(f"{c} {k} (n={n})")
        axes.ravel()[-1].hist(pts_per_frame, bins=21)
        axes.ravel()[-1].set_title("points / frame")
        fig.tight_layout()
        out = os.path.join(args.out_dir, f"hist_{c.lower()}.png")
        fig.savefig(out, dpi=110)
        plt.close(fig)
        print("wrote", out)

    with open(os.path.join(args.out_dir, "stats.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))


def rgb_mean(ds: KittiDataset) -> np.ndarray:
    """The mean over `ds`'s frames of each frame's mean R, G and B."""
    total = np.zeros(3)
    for name in sorted({s.name for s in ds.sample_list}):
        total += np.mean(read_png(ds.get_rgb_image_path(name)).reshape(-1, 3), axis=0)
    return total / ds.num_samples


def cmd_mean(args):
    cfg = DatasetConfig(dataset_dir=args.dataset_dir)
    mean = rgb_mean(KittiDataset(cfg, args.data_split))
    print("RGB means: [{:.4f}, {:.4f}, {:.4f}]".format(*mean))
    print("(img extractors use the full-KITTI constants, "
          "img_vgg_pyr.KITTI_RGB_MEANS)")


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    h = sub.add_parser("histograms")
    h.add_argument("--dataset_dir", required=True)
    h.add_argument("--data_split", default="trainval")
    h.add_argument("--out_dir", required=True)
    h.add_argument("--classes", default=None,
                   help="comma list; default: dataset classes")
    h.set_defaults(fn=cmd_histograms)
    m = sub.add_parser("mean")
    m.add_argument("--dataset_dir", required=True)
    m.add_argument("--data_split", default="train")
    m.set_defaults(fn=cmd_mean)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
