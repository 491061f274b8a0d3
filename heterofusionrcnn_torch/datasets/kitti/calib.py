"""KITTI calibration IO (parity with hf/core/calib_utils.py).

Numpy copy of heterofusionrcnn_tpu/datasets/kitti/calib.py; host side, in
the input pipeline.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class FrameCalib:
    """Per-frame calibration (reference FrameCalibrationData :7-29)."""

    p0: np.ndarray = None  # (3, 4)
    p1: np.ndarray = None
    p2: np.ndarray = None  # left color camera projection
    p3: np.ndarray = None
    r0_rect: np.ndarray = None  # (3, 3)
    tr_velodyne_to_cam: np.ndarray = None  # (3, 4)


def read_calibration(calib_dir: str, img_idx: int) -> FrameCalib:
    """Parse a KITTI calib txt (reference read_calibration :55-112)."""
    path = os.path.join(calib_dir, "%06d.txt" % img_idx)
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                rows.append(parts)

    calib = FrameCalib()
    ps = []
    for i in range(4):
        vals = np.array([float(v) for v in rows[i][1:]], np.float64)
        ps.append(vals.reshape(3, 4))
    calib.p0, calib.p1, calib.p2, calib.p3 = ps
    calib.r0_rect = np.array(
        [float(v) for v in rows[4][1:]], np.float64
    ).reshape(3, 3)
    calib.tr_velodyne_to_cam = np.array(
        [float(v) for v in rows[5][1:]], np.float64
    ).reshape(3, 4)
    return calib


def read_lidar(velo_dir: str, img_idx: int) -> np.ndarray:
    """Read a velodyne .bin -> (N, 4) [x, y, z, intensity]
    (reference read_lidar :327-369)."""
    path = os.path.join(velo_dir, "%06d.bin" % img_idx)
    return np.fromfile(path, np.float32).reshape(-1, 4)


def lidar_to_cam_frame(xyz_lidar: np.ndarray, calib: FrameCalib) -> np.ndarray:
    """velodyne frame -> rectified cam0 frame: R0_rect @ Tr_velo_to_cam @ p
    (reference lidar_to_cam_frame :370-407)."""
    r0 = np.eye(4)
    r0[:3, :3] = calib.r0_rect
    tr = np.eye(4)
    tr[:3, :] = calib.tr_velodyne_to_cam
    homog = np.hstack([xyz_lidar, np.ones((xyz_lidar.shape[0], 1))])
    out = (r0 @ tr @ homog.T).T
    return out[:, :3]


def project_to_image(points: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Rect-frame 3D points -> image pixels.

    Args:
      points: (N, 3); p: (3, 4) projection matrix.
    Returns:
      (N, 2) pixel coords. (Reference project_to_image :280-296 uses (3, N)
      in / (2, N) out; we use row-major.)
    """
    homog = np.hstack([points, np.ones((points.shape[0], 1))])
    proj = (p @ homog.T).T
    return proj[:, :2] / proj[:, 2:3]


def flip_calib_p2(p2: np.ndarray, image_shape) -> np.ndarray:
    """Adjust P2 for a horizontally flipped image (hf/datasets/kitti/
    kitti_aug.py flip_stereo_calib_p2 :99-118): cx mirrors about the width,
    tx negates."""
    flipped = p2.copy()
    flipped[0, 2] = image_shape[1] - p2[0, 2]
    flipped[0, 3] = -p2[0, 3]
    return flipped
