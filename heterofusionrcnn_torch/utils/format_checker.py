"""Shape checks of the port's array formats at pipeline boundaries
(numpy copy of heterofusionrcnn_tpu/utils/format_checker.py, the same
`ValueError` messages). Host-side: they take numpy arrays, lists or CPU
tensors."""

from __future__ import annotations

import numpy as np


def check_box_3d_format(boxes) -> None:
    """box_3d: (..., 7) [x, y, z, l, w, h, ry]."""
    arr = np.asarray(boxes)
    if arr.shape[-1] != 7:
        raise ValueError(f"box_3d must have last dim 7, got {arr.shape}")


def check_box_8c_format(corners) -> None:
    """box_8c: (..., 8, 3) ordered corners."""
    arr = np.asarray(corners)
    if arr.shape[-2:] != (8, 3):
        raise ValueError(f"box_8c must end in (8, 3), got {arr.shape}")


def check_bev_box_format(boxes) -> None:
    """BEV box: (..., 5) [x1, z1, x2, z2, ry]."""
    arr = np.asarray(boxes)
    if arr.shape[-1] != 5:
        raise ValueError(f"bev box must have last dim 5, got {arr.shape}")


def check_anchor_format(anchors) -> None:
    """anchor: (..., 6) [x, y, z, dim_x, dim_y, dim_z]."""
    arr = np.asarray(anchors)
    if arr.shape[-1] != 6:
        raise ValueError(f"anchor must have last dim 6, got {arr.shape}")


def check_point_cloud_format(pc) -> None:
    """point cloud: (..., N, 4) [x, y, z, intensity]."""
    arr = np.asarray(pc)
    if arr.shape[-1] != 4:
        raise ValueError(f"point cloud must have last dim 4, got {arr.shape}")


def check_proposal_file_format(rows) -> None:
    """proposals_and_scores rows: (n, 8) box_3d + score."""
    arr = np.asarray(rows)
    if arr.ndim != 2 or arr.shape[-1] != 8:
        raise ValueError(f"proposal rows must be (n, 8), got {arr.shape}")


def check_final_prediction_file_format(rows) -> None:
    """final_predictions_and_scores rows: (n, 9) box_3d + score + class."""
    arr = np.asarray(rows)
    if arr.ndim != 2 or arr.shape[-1] != 9:
        raise ValueError(f"final prediction rows must be (n, 9), got {arr.shape}")
