"""Data augmentation (parity with hf/datasets/kitti/kitti_aug.py). Numpy copy
of heterofusionrcnn_tpu/datasets/kitti/augmentation.py.

Host-side numpy; RNG is passed explicitly for deterministic, per-host-shardable
pipelines (the reference used the global numpy RNG).
"""

from __future__ import annotations

import numpy as np

AUG_FLIPPING = "flipping"
AUG_PCA_JITTER = "pca_jitter"


def flip_image(image: np.ndarray) -> np.ndarray:
    return np.fliplr(image)


def flip_points(points: np.ndarray) -> np.ndarray:
    """Negate x of (N, >=3) points (kitti_aug.flip_points :16-21)."""
    out = points.copy()
    out[:, 0] = -points[:, 0]
    return out


def flip_boxes_3d(boxes_3d: np.ndarray, flip_ry: bool = True) -> np.ndarray:
    """Mirror boxes about x=0 (kitti_aug.flip_boxes_3d :57-82):
    ry >= 0 -> pi - ry, ry < 0 -> -pi - ry, x -> -x."""
    out = boxes_3d.copy()
    if flip_ry:
        above = boxes_3d[:, 6] >= 0
        out[above, 6] = np.pi - boxes_3d[above, 6]
        out[~above, 6] = -np.pi - boxes_3d[~above, 6]
    out[:, 0] = -boxes_3d[:, 0]
    return out


def flip_ground_plane(ground_plane: np.ndarray) -> np.ndarray:
    out = ground_plane.copy()
    out[0] = -ground_plane[0]
    return out


def compute_pca(image: np.ndarray) -> np.ndarray:
    """Per-image PCA of pixel colors (kitti_aug.compute_pca :121-151).

    Same math as the reference but float32 matmul covariance instead of the
    float64 np.cov path — the reference's per-image jitter was ~60% of the
    whole sample-load cost."""
    assert image.dtype == np.uint8
    data = image.reshape(-1, 3).astype(np.float32) * (1.0 / 255.0)
    mean = data.mean(axis=0)
    centered = data - mean
    covariance = (centered.T @ centered) / (len(data) - 1)
    e_vals, e_vecs = np.linalg.eigh(covariance.astype(np.float64))
    return np.sqrt(np.maximum(e_vals, 0)) * e_vecs


def apply_pca_jitter(image: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Add PCA color noise with N(0, 0.1) magnitudes
    (kitti_aug.add_pca_jitter :154-185). Single-pass: the noise is a
    per-channel constant, so work in pixel units directly."""
    assert image.dtype == np.uint8
    pca = compute_pca(image)
    magnitude = rng.standard_normal(3) * 0.1
    noise = (pca * magnitude).sum(axis=1)  # per-channel, in [0,1] units
    out = image.astype(np.float32)
    out += noise.astype(np.float32) * 255.0
    np.clip(out, 0.0, 255.0, out=out)
    return out.astype(np.uint8)
