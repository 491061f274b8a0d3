"""Per-class size clusters for the PyTorch port (counterpart of
tools/gen_label_clusters.py): runs the clustering over the chosen split and
writes the txt caches that the port's KittiDataset reads at startup.

    python tools/torch_gen_label_clusters.py --dataset_dir /data/Kitti/object \
        --cluster_split train --cache_dir /data/label_clusters
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np

from heterofusionrcnn_torch.datasets.kitti import clusters as cluster_lib


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dataset_dir", required=True)
    parser.add_argument("--cluster_split", default="train")
    parser.add_argument("--cache_dir", required=True)
    parser.add_argument("--classes", nargs="*", default=["Car", "Pedestrian", "Cyclist"])
    parser.add_argument("--num_clusters", type=int, nargs="*", default=[1, 1, 1])
    return parser.parse_args(argv)


def main(argv=None):
    """Writes the caches; returns (clusters, std_devs), (k, 3) arrays per class."""
    args = parse_args(argv)
    label_dir = os.path.join(args.dataset_dir, "training", "label_2")
    with open(os.path.join(args.dataset_dir, args.cluster_split + ".txt")) as f:
        names = [line.strip() for line in f if line.strip()]
    clusters, std_devs = cluster_lib.get_clusters(
        args.classes, args.num_clusters, label_dir, names,
        cache_dir=args.cache_dir, cluster_split=args.cluster_split)
    for cls, c, s in zip(args.classes, clusters, std_devs):
        print(f"{cls}: mean={np.asarray(c).round(3).tolist()} "
              f"std={np.asarray(s).round(3).tolist()}")
    return clusters, std_devs


if __name__ == "__main__":
    main()
