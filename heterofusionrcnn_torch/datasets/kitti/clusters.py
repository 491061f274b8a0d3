"""Per-class size clustering (parity with hf/core/label_cluster_utils.py).
Numpy copy of heterofusionrcnn_tpu/datasets/kitti/clusters.py.

Computes KMeans cluster centroids (mean [l, w, h] per class for k=1, the
production config) over the training labels, cached to the same txt layout as
the reference: <data_dir>/<dataset_name>/<cluster_split>/<Class>_<k>.txt with
k centroid rows followed by k std-dev rows, '%.3f' formatted. The centroids
feed the bin codec's mean sizes.
"""

from __future__ import annotations

import os

import numpy as np

from heterofusionrcnn_torch.datasets.kitti import labels as label_io


def _kmeans(data: np.ndarray, k: int, iters: int = 100, seed: int = 0):
    """Tiny numpy Lloyd's k-means (sufficient for <=2 clusters over 3-dim
    size vectors; the reference used sklearn)."""
    if k == 1:
        center = data.mean(axis=0, keepdims=True)
        return center, data.std(axis=0, keepdims=True)
    rng = np.random.default_rng(seed)
    centers = data[rng.choice(len(data), k, replace=False)]
    for _ in range(iters):
        assign = np.argmin(
            np.linalg.norm(data[:, None] - centers[None], axis=-1), axis=1
        )
        new_centers = np.stack(
            [
                data[assign == i].mean(axis=0) if (assign == i).any() else centers[i]
                for i in range(k)
            ]
        )
        if np.allclose(new_centers, centers):
            break
        centers = new_centers
    stds = np.stack(
        [
            data[assign == i].std(axis=0) if (assign == i).any() else np.zeros(3)
            for i in range(k)
        ]
    )
    return centers, stds


def get_clusters(
    classes,
    num_clusters,
    label_dir: str,
    sample_names,
    cache_dir: str | None = None,
    dataset_name: str = "kitti",
    cluster_split: str = "train",
):
    """Cluster centroids and std devs per class.

    Args:
      classes: list of class names.
      num_clusters: list of k per class.
      label_dir: KITTI label_2 dir.
      sample_names: sample names of the cluster split.
      cache_dir: optional root for txt caches.
    Returns:
      (clusters, std_devs): lists of (k, 3) arrays per class.
    """
    all_clusters, all_std_devs = [], []
    missing = []
    for cls, k in zip(classes, num_clusters):
        cached = _read_cache(cache_dir, dataset_name, cluster_split, cls, k)
        if cached is not None:
            all_clusters.append(cached[0])
            all_std_devs.append(cached[1])
        else:
            all_clusters.append(None)
            all_std_devs.append(None)
            missing.append(cls)

    if not missing:
        return all_clusters, all_std_devs

    # Gather [l, w, h] per class over the split.
    sizes = {cls: [] for cls in classes}
    for name in sample_names:
        for obj in label_io.read_labels(label_dir, int(name)):
            if obj.type in sizes:
                sizes[obj.type].append([obj.l, obj.w, obj.h])

    for i, (cls, k) in enumerate(zip(classes, num_clusters)):
        if all_clusters[i] is not None:
            continue
        data = np.asarray(sizes[cls], np.float64)
        if len(data) < k:
            raise ValueError(
                f"Number of '{cls}' labels ({len(data)}) < clusters ({k})"
            )
        centers, stds = _kmeans(data, k)
        # Sort clusters by volume for determinism (reference sorts by l).
        order = np.argsort(centers[:, 0])
        centers, stds = centers[order], stds[order]
        all_clusters[i] = centers
        all_std_devs[i] = stds
        _write_cache(cache_dir, dataset_name, cluster_split, cls, k, centers, stds)

    return all_clusters, all_std_devs


def _cache_path(cache_dir, dataset_name, cluster_split, cls, k):
    return os.path.join(cache_dir, dataset_name, cluster_split, f"{cls}_{k}.txt")


def _read_cache(cache_dir, dataset_name, cluster_split, cls, k):
    if cache_dir is None:
        return None
    path = _cache_path(cache_dir, dataset_name, cluster_split, cls, k)
    if not os.path.isfile(path):
        return None
    data = np.loadtxt(path).reshape(-1, 3)
    return data[:k], data[k:]


def _write_cache(cache_dir, dataset_name, cluster_split, cls, k, centers, stds):
    if cache_dir is None:
        return
    path = _cache_path(cache_dir, dataset_name, cluster_split, cls, k)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, np.vstack([centers, stds]), fmt="%.3f")
