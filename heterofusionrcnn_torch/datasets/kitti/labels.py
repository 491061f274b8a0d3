"""KITTI object label IO and filtering (parity with hf/core/obj_utils.py and
hf/datasets/kitti/kitti_utils.py). Numpy copy of
heterofusionrcnn_tpu/datasets/kitti/labels.py."""

from __future__ import annotations

import dataclasses
import os

import numpy as np

# KITTI difficulty thresholds (kitti_utils.py:15-17): min box height (px),
# max occlusion, max truncation for (easy, moderate, hard).
DIFFICULTY_HEIGHT = (40, 25, 25)
DIFFICULTY_OCCLUSION = (0, 1, 2)
DIFFICULTY_TRUNCATION = (0.15, 0.3, 0.5)


@dataclasses.dataclass
class ObjectLabel:
    """One KITTI label row (reference ObjectLabel, obj_utils.py:8-106)."""

    type: str = ""
    truncation: float = 0.0
    occlusion: float = 0.0
    alpha: float = 0.0
    x1: float = 0.0
    y1: float = 0.0
    x2: float = 0.0
    y2: float = 0.0
    h: float = 0.0
    w: float = 0.0
    l: float = 0.0
    t: tuple = (0.0, 0.0, 0.0)
    ry: float = 0.0
    score: float = 0.0


def read_labels(label_dir: str, img_idx: int, results: bool = False):
    """Parse a KITTI label txt into ObjectLabels (obj_utils.read_labels)."""
    path = os.path.join(label_dir, "%06d.txt" % img_idx)
    labels = []
    if not os.path.exists(path):
        return labels
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            obj = ObjectLabel(
                type=p[0],
                truncation=float(p[1]),
                occlusion=float(p[2]),
                alpha=float(p[3]),
                x1=float(p[4]),
                y1=float(p[5]),
                x2=float(p[6]),
                y2=float(p[7]),
                h=float(p[8]),
                w=float(p[9]),
                l=float(p[10]),
                t=(float(p[11]), float(p[12]), float(p[13])),
                ry=float(p[14]),
            )
            if results and len(p) > 15:
                obj.score = float(p[15])
            labels.append(obj)
    return labels


def object_label_to_box_3d(obj: ObjectLabel) -> np.ndarray:
    """ObjectLabel -> box_3d [x, y, z, l, w, h, ry]
    (box_3d_encoder.object_label_to_box_3d :38-58)."""
    return np.array(
        [obj.t[0], obj.t[1], obj.t[2], obj.l, obj.w, obj.h, obj.ry], np.float32
    )


def box_3d_to_object_label(box_3d: np.ndarray, obj_type: str = "Car") -> ObjectLabel:
    """Inverse of :func:`object_label_to_box_3d`."""
    obj = ObjectLabel(type=obj_type)
    obj.t = (float(box_3d[0]), float(box_3d[1]), float(box_3d[2]))
    obj.l = float(box_3d[3])
    obj.w = float(box_3d[4])
    obj.h = float(box_3d[5])
    obj.ry = float(box_3d[6])
    return obj


def class_str_to_index(class_str: str, classes) -> int:
    """Class name -> 1-based index (0 = background)
    (kitti_utils.class_str_to_index :39-56)."""
    if class_str in classes:
        return classes.index(class_str) + 1
    raise ValueError(f"Invalid class string {class_str}, not in {classes}")


def check_difficulty(obj: ObjectLabel, difficulty: int) -> bool:
    """KITTI difficulty predicate (kitti_utils._check_difficulty :146-160)."""
    return (
        obj.occlusion <= DIFFICULTY_OCCLUSION[difficulty]
        and obj.truncation <= DIFFICULTY_TRUNCATION[difficulty]
        and (obj.y2 - obj.y1) >= DIFFICULTY_HEIGHT[difficulty]
    )


def filter_labels(
    objects,
    classes,
    difficulty: int | None = None,
    max_occlusion: float | None = None,
):
    """Filter labels by class / difficulty / occlusion
    (kitti_utils.filter_labels :106-144)."""
    out = []
    for obj in objects:
        if obj.type not in classes:
            continue
        if difficulty is not None and not check_difficulty(obj, difficulty):
            continue
        if max_occlusion and obj.occlusion > max_occlusion:
            continue
        out.append(obj)
    return out


def get_road_plane(img_idx: int, planes_dir: str) -> np.ndarray:
    """Read a ground plane file (obj_utils.get_road_plane :280-314): 4
    coefficients [a, b, c, d], normalized, flipped so b < 0 (plane normal
    points up in the y-down camera frame)."""
    path = os.path.join(planes_dir, "%06d.txt" % img_idx)
    with open(path) as f:
        lines = f.readlines()
    coeffs = np.array([float(v) for v in lines[3].split()], np.float32)
    if coeffs[1] > 0:
        coeffs = -coeffs
    norm = np.linalg.norm(coeffs[:3])
    return coeffs / norm
