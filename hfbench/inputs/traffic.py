"""The one generator of the benchmark's traffic: it reads a traffic file's
parameters and the seed, and gives the batches a cell stages on the card.

A traffic file (`hfbench/traffic/<name>.json`) gives:

  - `batch`: frames a batch;
  - `repeats`: how many times each fixture frame appears over the staged
    batches, each appearance with a point sample of its own; every seed
    stages the same appearances (the same work), grouped and ordered by
    the seed;
  - `flipped_share`: the share of each frame's appearances mirrored;
  - `labels`: whether the batches carry the RPN's training labels;
  - `trace_start`, `trace_iterations`: which iterations of the window a
    `--trace 1` run profiles.

The staged batches are cycled through the window in order, back to back.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from hfbench.inputs import kitti

MAX_GT_BOXES = 32  # the GT boxes a batch pads to (the port's max_gt_boxes)


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator of one stream (0: the schedule, 1: the check's
    sample of batches)."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])


def schedule(traffic: dict, names: List[str], seed: int):
    """[(frame name, appearance, flip)] of every staged batch: the seed
    groups and orders the appearances; which appearances are mirrored is
    the same for every seed."""
    b, repeats = traffic["batch"], traffic["repeats"]
    flips = int(round(traffic["flipped_share"] * repeats))
    slots = [(n, i, i < flips) for n in names for i in range(repeats)]
    if len(slots) % b:
        raise ValueError(f"{len(slots)} frame appearances do not fill batches of {b}")
    order = rng(seed, 0).permutation(len(slots))
    slots = [slots[i] for i in order]
    return [slots[i:i + b] for i in range(0, len(slots), b)]


def staged_batches(traffic: dict, seed: int, num_points: int, img_w: int,
                   img_h: int) -> List[Dict[str, np.ndarray]]:
    """The host batches of `traffic` for `seed`, as the model takes them.
    Each appearance's point sample is drawn from its own stream, the same
    for every seed, so that every seed stages the same work, grouped and
    ordered by the seed."""
    frames = kitti.load_frames()
    index = {name: k for k, name in enumerate(frames)}
    out, resized = [], {}
    for batch in schedule(traffic, list(frames), seed):
        samples = [kitti.make_sample(frames[name], np.random.default_rng([index[name], i]),
                                     num_points, img_w, img_h, flip, traffic["labels"], resized)
                   for name, i, flip in batch]
        stacked = {k: np.stack([s[k] for s in samples]) for k in samples[0] if k != "label_boxes"}
        if traffic["labels"]:
            boxes = np.zeros((len(samples), MAX_GT_BOXES, 7), np.float32)
            for i, s in enumerate(samples):
                n = min(len(s["label_boxes"]), MAX_GT_BOXES)
                boxes[i, :n] = s["label_boxes"][:n]
            stacked["label_boxes_3d"] = boxes
        out.append(stacked)
    return out
