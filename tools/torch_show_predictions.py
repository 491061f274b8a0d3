"""Prediction visualization on the PyTorch port's data layer (counterpart
of tools/show_predictions.py, with its flags and files), rendered
headlessly with matplotlib.

Draws, per sample:
  - the RGB image with projected 3D boxes (GT green, predictions by score),
  - a BEV scatter of the point cloud with oriented box footprints.

    python tools/torch_show_predictions.py --dataset_dir tests/fixtures/kitti \
        --predictions_dir outputs/rcnn_multiclass/predictions \
        --step 100 --data_split val --out_dir /tmp/vis

Frames come through `heterofusionrcnn_torch.datasets.kitti`, images
through its PNG reader (`image.read_png`, RGB), so no OpenCV is needed.
Host only; matplotlib is imported where a figure is drawn, so the module
imports without it (the card's machine has none: there, drawing raises
ImportError).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np

from heterofusionrcnn_torch.configs import DatasetConfig
from heterofusionrcnn_torch.datasets.kitti import calib as calib_io
from heterofusionrcnn_torch.datasets.kitti import labels as label_io
from heterofusionrcnn_torch.datasets.kitti import pointcloud as pc_lib
from heterofusionrcnn_torch.datasets.kitti.dataset import KittiDataset
from heterofusionrcnn_torch.datasets.kitti.image import read_png
from heterofusionrcnn_torch.utils.np_box_ops import box_3d_to_corners

# Box edges between the 8 ordered corners (bottom 0-3, top 4-7).
_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _pyplot():
    """matplotlib's pyplot on the Agg backend; ImportError (naming
    matplotlib) where it is not installed, as on the card's machine."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_boxes_on_image(ax, boxes_3d, p2, color, lw=1.2, scores=None):
    for i, box in enumerate(boxes_3d):
        corners = box_3d_to_corners(box[None])[0]
        uv = calib_io.project_to_image(corners, p2)
        for a, b in _EDGES:
            ax.plot([uv[a, 0], uv[b, 0]], [uv[a, 1], uv[b, 1]],
                    color=color, linewidth=lw)
        if scores is not None:
            ax.text(uv[:, 0].min(), uv[:, 1].min() - 2, f"{scores[i]:.2f}",
                    color=color, fontsize=7)


def draw_boxes_on_bev(ax, boxes_3d, color, lw=1.2):
    from matplotlib.patches import Polygon

    for box in boxes_3d:
        corners = box_3d_to_corners(box[None])[0][:4][:, [0, 2]]
        ax.add_patch(Polygon(corners, closed=True, fill=False,
                             edgecolor=color, linewidth=lw))


def visualize_sample(
    dataset, sample_name, predictions, out_path, max_points=20000
):
    """predictions: (n, 9) rows [box_3d(7), score, cls] or None."""
    plt = _pyplot()
    p2 = calib_io.read_calibration(dataset.calib_dir, int(sample_name)).p2
    rgb = read_png(dataset.get_rgb_image_path(sample_name))

    gt = label_io.read_labels(dataset.label_dir, int(sample_name))
    gt = label_io.filter_labels(gt, dataset.classes)
    gt_boxes = (
        np.stack([label_io.object_label_to_box_3d(o) for o in gt])
        if gt else np.zeros((0, 7))
    )

    pc = pc_lib.get_lidar_point_cloud(
        int(sample_name), dataset.calib_dir, dataset.velo_dir,
        im_size=[rgb.shape[1], rgb.shape[0]],
    )
    if len(pc) > max_points:
        pc = pc[:: len(pc) // max_points]

    fig, (ax_img, ax_bev) = plt.subplots(
        2, 1, figsize=(12, 12),
        gridspec_kw={"height_ratios": [1, 2]},
    )
    ax_img.imshow(rgb)
    draw_boxes_on_image(ax_img, gt_boxes, p2, "lime")
    if predictions is not None and len(predictions):
        draw_boxes_on_image(
            ax_img, predictions[:, :7], p2, "red",
            scores=predictions[:, 7],
        )
    ax_img.set_axis_off()

    ax_bev.scatter(pc[:, 0], pc[:, 2], s=0.3, c=-pc[:, 1], cmap="viridis")
    draw_boxes_on_bev(ax_bev, gt_boxes, "lime")
    if predictions is not None and len(predictions):
        draw_boxes_on_bev(ax_bev, predictions[:, :7], "red")
    ax_bev.set_xlim(-40, 40)
    ax_bev.set_ylim(0, 70)
    ax_bev.set_aspect("equal")
    ax_bev.set_xlabel("x (m)")
    ax_bev.set_ylabel("z (m)")

    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_dir", required=True)
    parser.add_argument("--data_split", default="val")
    parser.add_argument("--predictions_dir", default=None,
                        help="predictions root containing "
                             "final_predictions_and_scores")
    parser.add_argument("--step", default=None)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--max_samples", type=int, default=10)
    args = parser.parse_args(argv)

    cfg = DatasetConfig(dataset_dir=args.dataset_dir, data_split=args.data_split)
    dataset = KittiDataset(cfg, "val")
    os.makedirs(args.out_dir, exist_ok=True)

    names = sorted({s.name for s in dataset.sample_list})[: args.max_samples]
    for name in names:
        preds = None
        if args.predictions_dir and args.step:
            path = os.path.join(
                args.predictions_dir, "final_predictions_and_scores",
                args.data_split, str(args.step), name + ".txt",
            )
            if os.path.exists(path):
                preds = np.loadtxt(path).reshape(-1, 9)
        out_path = os.path.join(args.out_dir, name + ".png")
        visualize_sample(dataset, name, preds, out_path)
        print("wrote", out_path)


if __name__ == "__main__":
    main()
