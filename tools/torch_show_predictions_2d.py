"""Rich 2D prediction viewer on the PyTorch port's data layer (counterpart
of tools/show_predictions_2d.py, with its flags, views and files).

Renders, per sample of a split, any subset of three views:
  proposals    RPN proposal wireframes (cornflowerblue) over difficulty-
               colored GT
  predictions  final RCNN boxes, class-colored, with optional projected-2D
               rectangles, orientation markers and "(score, IoU)" text
  overlaid     proposals + predictions on one figure

GT rendering mirrors the reference's difficulty scheme: box color by
occlusion level (green/yellow/red/white), dashed lines when truncation>0.1,
DontCare regions as cyan rectangles, class+alpha text labels.

    python tools/torch_show_predictions_2d.py --dataset_dir tests/fixtures/kitti \
        --predictions_dir outputs/rcnn_multiclass/predictions \
        --data_split val --views predictions,overlaid --out_dir /tmp/vis2d

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
from heterofusionrcnn_torch.datasets.kitti.dataset import KittiDataset
from heterofusionrcnn_torch.datasets.kitti.image import read_png
from heterofusionrcnn_torch.utils.np_box_ops import box_3d_to_corners

# Class colors (the reference demo's BOX_COLOUR_SCHEME).
CLASS_COLORS = {"Car": "#00FF00", "Pedestrian": "#00FFFF", "Cyclist": "#FFFF00"}
# GT box color by occlusion level 0-3 (difficulty scheme).
OCCLUSION_COLORS = ["#00cc00", "y", "r", "w"]

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


def _project(pts3, p2):
    return calib_io.project_to_image(np.asarray(pts3, np.float32), p2)


def _wireframe(ax, box_3d, p2, color, lw=1.6, linestyle="solid"):
    corners = box_3d_to_corners(np.asarray(box_3d)[None])[0]
    if corners[:, 2].min() < 0.1:
        # Any corner behind the image plane projects to garbage; the
        # reference's projector discards these boxes entirely.
        return None
    uv = _project(corners, p2)
    for a, b in _EDGES:
        ax.plot([uv[a, 0], uv[b, 0]], [uv[a, 1], uv[b, 1]],
                color=color, linewidth=lw, linestyle=linestyle)
    return uv


def _orientation_marker(ax, box_3d, p2):
    """Heading line from the box bottom-center along +length (the
    reference's compute_orientation_3d analog), white-over-black."""
    x, y, z, length, _, _, ry = np.asarray(box_3d, np.float64)
    fwd = np.array([np.cos(ry), 0.0, -np.sin(ry)])
    p0 = np.array([x, y, z])
    p1 = p0 + 0.6 * length * fwd
    if p0[2] < 0.1 or p1[2] < 0.1:  # behind the camera
        return
    uv = _project(np.stack([p0, p1]), p2)
    ax.plot(uv[:, 0], uv[:, 1], linewidth=4, color="w")
    ax.plot(uv[:, 0], uv[:, 1], linewidth=2, color="k")


def _box2d_from_3d(box_3d, p2, im_w, im_h):
    corners = box_3d_to_corners(np.asarray(box_3d)[None])[0]
    uv = _project(corners, p2)
    x1 = np.clip(uv[:, 0].min(), 0, im_w)
    x2 = np.clip(uv[:, 0].max(), 0, im_w)
    y1 = np.clip(uv[:, 1].min(), 0, im_h)
    y2 = np.clip(uv[:, 1].max(), 0, im_h)
    return np.array([x1, y1, x2, y2])


def _iou_2d(box, gt_boxes):
    if len(gt_boxes) == 0:
        return 0.0
    gt = np.asarray(gt_boxes, np.float64)
    ix1 = np.maximum(box[0], gt[:, 0])
    iy1 = np.maximum(box[1], gt[:, 1])
    ix2 = np.minimum(box[2], gt[:, 2])
    iy2 = np.minimum(box[3], gt[:, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = a + b - inter
    return float((inter / np.maximum(union, 1e-9)).max())


def draw_gt(ax, objects, p2, difficulty_colors=True, orientations=False):
    """GT layer: difficulty-colored 3D wireframes + 2D label text;
    DontCare as cyan rectangles."""
    from matplotlib.patches import Rectangle

    for obj in objects:
        if obj.type == "DontCare":
            ax.add_patch(Rectangle(
                (obj.x1, obj.y1), obj.x2 - obj.x1, obj.y2 - obj.y1,
                linewidth=1.5, edgecolor="c", facecolor="none",
            ))
            continue
        color = (OCCLUSION_COLORS[min(int(obj.occlusion), 3)]
                 if difficulty_colors else "r")
        style = "dashed" if obj.truncation > 0.1 else "solid"
        box = label_io.object_label_to_box_3d(obj)
        _wireframe(ax, box, p2, color, lw=1.6, linestyle=style)
        if orientations:
            _orientation_marker(ax, box, p2)
        ax.text(
            (obj.x1 + obj.x2) / 2, obj.y1, f"{obj.type}\n{obj.alpha:1.1f} rad",
            va="bottom", ha="center", color=color, fontsize=7,
            backgroundcolor="k",
        )


def draw_proposals(ax, proposals, p2, score_thresh, orientations=False):
    kept = proposals[proposals[:, 7] >= score_thresh]
    n = 0
    for row in kept:
        if _wireframe(ax, row[:7], p2, "cornflowerblue", lw=1.4) is None:
            continue
        n += 1
        if orientations:
            _orientation_marker(ax, row[:7], p2)
    return n


def draw_predictions(
    ax, preds, p2, classes, score_thresh, im_wh, gt_boxes_2d,
    draw_2d_rect=True, orientations=True, show_score=True, show_iou=True,
):
    from matplotlib.patches import Rectangle

    kept = preds[preds[:, 7] >= score_thresh]
    n = 0
    for row in kept:
        cls = classes[int(row[8])] if int(row[8]) < len(classes) else "Car"
        color = CLASS_COLORS.get(cls, "#FF00FF")
        if _wireframe(ax, row[:7], p2, color, lw=1.8) is None:
            continue
        n += 1
        if orientations:
            _orientation_marker(ax, row[:7], p2)
        box2d = _box2d_from_3d(row[:7], p2, *im_wh)
        if draw_2d_rect:
            ax.add_patch(Rectangle(
                (box2d[0], box2d[1]), box2d[2] - box2d[0], box2d[3] - box2d[1],
                linewidth=1.0, edgecolor=color, facecolor="none",
                linestyle="dotted",
            ))
        parts = []
        if show_score:
            parts.append(f"{row[7]:.2f}")
        if show_iou:
            parts.append(f"{_iou_2d(box2d, gt_boxes_2d):.2f}")
        if parts:
            ax.text(
                (box2d[0] + box2d[2]) / 2, box2d[1], "(" + ", ".join(parts) + ")",
                va="bottom", ha="center", color=color, fontsize=7,
                backgroundcolor="k",
            )
    return n


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_dir", required=True)
    parser.add_argument("--data_split", default="val")
    parser.add_argument("--predictions_dir", required=True,
                        help="predictions root (contains "
                             "proposals_and_scores / "
                             "final_predictions_and_scores)")
    parser.add_argument("--proposals_dir", default=None,
                        help="predictions root holding proposals_and_scores "
                             "(default: --predictions_dir; the RPN and RCNN "
                             "stages write under different checkpoint names)")
    parser.add_argument("--step", default=None,
                        help="checkpoint step (default: latest available)")
    parser.add_argument("--views", default="predictions",
                        help="comma list of proposals,predictions,overlaid")
    parser.add_argument("--out_dir", default=None,
                        help="default: <predictions_dir>/images_2d")
    parser.add_argument("--rpn_score_threshold", type=float, default=0.1)
    parser.add_argument("--rcnn_score_threshold", type=float, default=0.1)
    parser.add_argument("--max_samples", type=int, default=50)
    parser.add_argument("--no_orientations", action="store_true")
    parser.add_argument("--no_2d_boxes", action="store_true")
    parser.add_argument("--no_score", action="store_true")
    parser.add_argument("--no_iou", action="store_true")
    parser.add_argument("--skip_empty", action="store_true",
                        help="skip samples with no kept detections")
    args = parser.parse_args(argv)

    views = [v.strip() for v in args.views.split(",") if v.strip()]
    bad = set(views) - {"proposals", "predictions", "overlaid"}
    if bad:
        parser.error(f"unknown views: {sorted(bad)}")

    cfg = DatasetConfig(dataset_dir=args.dataset_dir, data_split=args.data_split)
    dataset = KittiDataset(cfg, "val")
    classes = list(dataset.classes)

    prop_root = os.path.join(
        args.proposals_dir or args.predictions_dir,
        "proposals_and_scores", args.data_split)
    pred_root = os.path.join(
        args.predictions_dir, "final_predictions_and_scores", args.data_split)
    step = args.step
    if step is None:
        for root in (pred_root, prop_root):
            if os.path.isdir(root) and os.listdir(root):
                step = sorted(os.listdir(root), key=int)[-1]
                break
    if step is None:
        raise SystemExit(f"no checkpoint steps under {pred_root}")
    out_base = args.out_dir or os.path.join(args.predictions_dir, "images_2d")

    plt = _pyplot()
    names = sorted({s.name for s in dataset.sample_list})[: args.max_samples]
    for name in names:
        p2 = calib_io.read_calibration(dataset.calib_dir, int(name)).p2
        rgb = read_png(dataset.get_rgb_image_path(name))
        im_wh = (rgb.shape[1], rgb.shape[0])

        gt_all = label_io.read_labels(dataset.label_dir, int(name))
        gt = [o for o in gt_all if o.type in classes or o.type == "DontCare"]
        gt_boxes_2d = [
            [o.x1, o.y1, o.x2, o.y2] for o in gt if o.type != "DontCare"
        ]

        def load(root, width):
            path = os.path.join(root, step, name + ".txt")
            if not os.path.exists(path):
                return np.zeros((0, width))
            return np.loadtxt(path).reshape(-1, width)

        proposals = load(prop_root, 8)
        preds = load(pred_root, 9)

        for view in views:
            fig, ax = plt.subplots(figsize=(12, 3.8))
            ax.imshow(rgb)
            n_drawn = 0
            if view == "proposals":
                draw_gt(ax, gt, p2, difficulty_colors=False)
                n_drawn = draw_proposals(
                    ax, proposals, p2, args.rpn_score_threshold,
                    orientations=False,
                )
            else:
                draw_gt(ax, gt, p2, orientations=not args.no_orientations)
                if view == "overlaid":
                    n_drawn += draw_proposals(
                        ax, proposals, p2, args.rpn_score_threshold)
                n_drawn += draw_predictions(
                    ax, preds, p2, classes, args.rcnn_score_threshold, im_wh,
                    gt_boxes_2d,
                    draw_2d_rect=not args.no_2d_boxes,
                    orientations=not args.no_orientations,
                    show_score=not args.no_score,
                    show_iou=not args.no_iou,
                )
            if n_drawn == 0 and args.skip_empty:
                plt.close(fig)
                continue
            ax.set_xlim(0, im_wh[0])
            ax.set_ylim(im_wh[1], 0)
            ax.set_axis_off()
            out_dir = os.path.join(out_base, view, str(step))
            os.makedirs(out_dir, exist_ok=True)
            out_path = os.path.join(out_dir, name + ".png")
            fig.tight_layout()
            fig.savefig(out_path, dpi=110)
            plt.close(fig)
            print("wrote", out_path)


if __name__ == "__main__":
    main()
