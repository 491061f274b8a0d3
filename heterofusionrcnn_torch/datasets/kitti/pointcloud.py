"""Point-cloud loading, frustum filtering, and fixed-size sampling.

Parity with hf/core/obj_utils.get_lidar_point_cloud (:221-279) and the
depth-stratified sampler in hf/datasets/kitti/kitti_dataset.py:341-365 —
vectorized numpy, explicit RNG. Port of
heterofusionrcnn_tpu/datasets/kitti/pointcloud.py: a frustum-filtered load
takes the native C++ loader (`native_loader.py`), as the JAX package does
where its library loads; `get_lidar_point_cloud_numpy` is its plain
version, which gives the same points byte for byte
(tests/test_torch_native_loader.py).
"""

from __future__ import annotations

import os

import numpy as np

from heterofusionrcnn_torch.datasets.kitti import calib as calib_io
from heterofusionrcnn_torch.datasets.kitti.native_loader import load_and_filter_native


def get_lidar_point_cloud(
    img_idx: int, calib_dir: str, velo_dir: str, im_size=None
) -> np.ndarray:
    """Velodyne -> rect-frame points, optionally frustum-filtered to the
    image: through the native loader whenever `im_size` is given, else
    `get_lidar_point_cloud_numpy`.

    Args:
      im_size: (w, h) or None.
    Returns:
      (N, 4) [x, y, z, intensity] in rect cam frame.
    """
    if im_size is None:
        return get_lidar_point_cloud_numpy(img_idx, calib_dir, velo_dir)
    calib = calib_io.read_calibration(calib_dir, img_idx)
    return load_and_filter_native(os.path.join(velo_dir, "%06d.bin" % img_idx), calib, im_size)


def get_lidar_point_cloud_numpy(
    img_idx: int, calib_dir: str, velo_dir: str, im_size=None
) -> np.ndarray:
    """The plain numpy load: velodyne -> rect-frame points, optionally
    frustum-filtered to the image.

    Args:
      im_size: (w, h) or None.
    Returns:
      (N, 4) [x, y, z, intensity] in rect cam frame.
    """
    calib = calib_io.read_calibration(calib_dir, img_idx)
    xyzi = calib_io.read_lidar(velo_dir, img_idx)
    pts = calib_io.lidar_to_cam_frame(xyzi[:, :3], calib)
    intensity = xyzi[:, 3]

    if im_size is None:
        return np.hstack([pts, intensity[:, None]]).astype(np.float32)

    # Keep points in front of the camera, then inside the image.
    front = pts[:, 2] > 0
    pts = pts[front]
    intensity = intensity[front]
    in_im = calib_io.project_to_image(pts, calib.p2)
    img_filter = (
        (in_im[:, 0] > 0)
        & (in_im[:, 0] < im_size[0])
        & (in_im[:, 1] > 0)
        & (in_im[:, 1] < im_size[1])
    )
    out = np.hstack([pts[img_filter], intensity[img_filter][:, None]])
    return out.astype(np.float32)


def get_area_filter(
    points: np.ndarray,
    area_extents: np.ndarray,
    ground_plane: np.ndarray | None = None,
    offset_dist: float = 2.0,
) -> np.ndarray:
    """Point filter by area extents + optional ground-plane offset (parity
    with obj_utils.get_point_filter :485-534): keeps points inside the
    [x, y, z] extents and, when a plane is given, with
    a*x + b*y + c*z + (d - offset_dist) < 0 — i.e. below the plane shifted
    `offset_dist` along its (upward) normal.

    Args:
      points: (N, 3); area_extents: (3, 2) [[xmin, xmax], [ymin, ymax],
        [zmin, zmax]]; ground_plane: (4,) [a, b, c, d] or None.
    Returns:
      (N,) bool mask.
    """
    extents = np.asarray(area_extents, np.float64)
    mask = (
        (points[:, 0] > extents[0, 0])
        & (points[:, 0] < extents[0, 1])
        & (points[:, 1] > extents[1, 0])
        & (points[:, 1] < extents[1, 1])
        & (points[:, 2] > extents[2, 0])
        & (points[:, 2] < extents[2, 1])
    )
    if ground_plane is not None:
        a, b, c, d = np.asarray(ground_plane, np.float64)
        dot = points[:, 0] * a + points[:, 1] * b + points[:, 2] * c + (
            d - offset_dist
        )
        mask &= dot < 0
    return mask


def depth_stratified_sample(
    pts_rect: np.ndarray,
    intensity: np.ndarray,
    num_points: int,
    rng: np.random.Generator,
    near_depth: float = 40.0,
):
    """Sample exactly `num_points` points, keeping all far (z >= 40m) points
    and randomly filling the rest from near points; oversample with
    replacement when the cloud is small (kitti_dataset.py:341-365).

    Returns:
      (num_points, 3) points, (num_points, 1) intensities.
    """
    n = len(pts_rect)
    if num_points < n:
        near_flag = pts_rect[:, 2] < near_depth
        far_idxs = np.flatnonzero(~near_flag)
        near_idxs = np.flatnonzero(near_flag)
        need_near = num_points - len(far_idxs)
        if need_near <= 0:
            # Degenerate: more far points than the budget; sample among far.
            choice = rng.choice(far_idxs, num_points, replace=False)
        else:
            near_choice = rng.choice(near_idxs, need_near, replace=False)
            choice = (
                np.concatenate([near_choice, far_idxs])
                if len(far_idxs) > 0
                else near_choice
            )
        rng.shuffle(choice)
    else:
        choice = np.arange(n, dtype=np.int64)
        if num_points > n:
            extra = rng.choice(
                choice, num_points - n, replace=num_points > 2 * n
            )
            choice = np.concatenate([choice, extra])
        rng.shuffle(choice)

    return pts_rect[choice], intensity[choice].reshape(-1, 1)
