"""KITTI-format prediction writer (parity with hf/core/evaluator_utils.
save_predictions_in_kitti_format :18-177 and box_3d_projector.
project_to_image_space :88-163). Copy of
heterofusionrcnn_tpu/runtime/kitti_writer.py that reads image sizes from the
PNG header (`image.png_size`) instead of PIL; its files are byte-identical.

Reads `final_predictions_and_scores` txts (rows: x y z l w h ry score cls)
and writes KITTI native-eval txt rows:
  type -1 -1 alpha x1 y1 x2 y2 h w l x y z ry score
"""

from __future__ import annotations

import os

import numpy as np

from heterofusionrcnn_torch.datasets.kitti import calib as calib_io
from heterofusionrcnn_torch.datasets.kitti.image import png_size
from heterofusionrcnn_torch.utils.np_box_ops import box_3d_to_corners


def project_box_to_image_space(
    box_3d: np.ndarray,
    calib_p2: np.ndarray,
    image_size,
    truncate: bool = True,
    discard_before_truncation: bool = True,
):
    """box_3d -> [x1, y1, x2, y2] in pixels, or None if outside/oversized
    (reference box_3d_projector.project_to_image_space)."""
    corners = box_3d_to_corners(box_3d[None])[0]  # (8, 3)
    uv = calib_io.project_to_image(corners, calib_p2)
    img_box = np.array(
        [uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(), uv[:, 1].max()]
    )
    if not truncate:
        return img_box

    image_w, image_h = image_size
    if (
        img_box[0] > image_w
        or img_box[1] > image_h
        or img_box[2] < 0
        or img_box[3] < 0
    ):
        return None
    if discard_before_truncation:
        if (img_box[2] - img_box[0]) > image_w * 0.8 or (
            img_box[3] - img_box[1]
        ) > image_h * 0.8:
            return None
    img_box[0] = max(img_box[0], 0)
    img_box[1] = max(img_box[1], 0)
    img_box[2] = min(img_box[2], image_w)
    img_box[3] = min(img_box[3], image_h)
    if not discard_before_truncation:
        if (img_box[2] - img_box[0]) > image_w * 0.8 and (
            img_box[3] - img_box[1]
        ) > image_h * 0.8:
            return None
    return img_box


def save_predictions_in_kitti_format(
    dataset,
    predictions_dir: str,
    score_threshold: float,
    global_step,
    out_dir: str | None = None,
):
    """Convert `final_predictions_and_scores/<split>/<step>` txts to KITTI
    native-eval `data/` txts.

    Args:
      dataset: KittiDataset (for sample names, image paths, calib).
      predictions_dir: the checkpoint's predictions root.
      score_threshold: minimum score kept.
      global_step: which step's predictions to convert.
    Returns:
      The kitti predictions dir.
    """
    score_threshold = round(score_threshold, 3)
    final_dir = os.path.join(
        predictions_dir,
        "final_predictions_and_scores",
        dataset.data_split,
        str(global_step),
    )
    kitti_dir = out_dir or os.path.join(
        predictions_dir,
        "kitti_native_eval",
        str(score_threshold),
        str(global_step),
        "data",
    )
    os.makedirs(kitti_dir, exist_ok=True)

    sample_names = sorted({s.name for s in dataset.sample_list})
    for sample_name in sample_names:
        out_path = os.path.join(kitti_dir, sample_name + ".txt")
        pred_path = os.path.join(final_dir, sample_name + ".txt")
        if not os.path.exists(pred_path):
            np.savetxt(out_path, [])
            continue

        preds = np.loadtxt(pred_path).reshape(-1, 9)
        preds = preds[preds[:, 7] >= score_threshold]
        if len(preds) == 0:
            np.savetxt(out_path, [])
            continue

        image_size = png_size(dataset.get_rgb_image_path(sample_name))
        p2 = calib_io.read_calibration(dataset.calib_dir, int(sample_name)).p2

        rows = []
        for pred in preds:
            img_box = project_box_to_image_space(
                pred[:7], p2, image_size, truncate=True
            )
            if img_box is None:
                continue
            cls_name = dataset.classes[int(pred[8])]
            # type trunc occl alpha x1 y1 x2 y2 h w l x y z ry score
            rows.append(
                [cls_name, -1, -1, -10]
                + [round(v, 3) for v in img_box]
                + [round(pred[5], 3), round(pred[4], 3), round(pred[3], 3)]
                + [round(v, 3) for v in pred[0:3]]
                + [round(pred[6], 3), round(pred[7], 3)]
            )

        with open(out_path, "w") as f:
            for row in rows:
                f.write(" ".join(str(v) for v in row) + "\r\n")

    return kitti_dir
