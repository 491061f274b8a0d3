"""The numbers that decide `correct`, each computed from what the timed
path produced and what the reference computes from the same inputs and
weights. `PERF.md` gives, for each number, the readings its limit was set
from.

Boxes are judged as rows [x, y, z, l, w, h, ry, score] (and class): a
program row is compared with the reference's candidate rows, every box a
proposal of that point or RoI could be (each class's decode, with its
softmax score), so that a discrete choice that a rounding tips one way in
the program and the other in the reference (a class argmax, an NMS order
between two near-equal scores) still finds its row. The widest gap of a
row to its nearest candidate catches a row that was altered or made from
wrong features; the set gap, the share of rows of either side with no row
of the other within `match_tol`, catches a wrong selection (a keep set
that suppresses too much or too little).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

# A class id scaled by this joins a row, so rows of two classes never match.
CLASS_SCALE = 1e6


def nearest_gaps(rows: torch.Tensor, cands: torch.Tensor, chunk: int = 1 << 22) -> torch.Tensor:
    """For each row of `rows` (m, F), the smallest L-infinity distance to a
    row of `cands` (n, F); inf where `cands` is empty."""
    if rows.shape[0] == 0:
        return rows.new_zeros(0)
    if cands.shape[0] == 0:
        return torch.full((rows.shape[0],), float("inf"), device=rows.device)
    step = max(1, chunk // max(1, rows.shape[0] * rows.shape[1]))
    best = torch.full((rows.shape[0],), float("inf"), device=rows.device, dtype=rows.dtype)
    for c in cands.split(step):
        d = (rows[:, None, :] - c[None, :, :]).abs().amax(-1).amin(-1)
        best = torch.minimum(best, d)
    return best


def set_gap_counts(a: torch.Tensor, b: torch.Tensor, tol: float):
    """(rows of a or b with no row of the other within tol, rows of both)."""
    missing = int((nearest_gaps(a, b) > tol).sum()) + int((nearest_gaps(b, a) > tol).sum())
    return missing, a.shape[0] + b.shape[0]


def box_rows(boxes: torch.Tensor, scores: torch.Tensor, classes=None) -> torch.Tensor:
    """(m, 7) boxes, (m,) scores, (m,) classes or None -> (m, 8 or 9) rows."""
    parts = [boxes.float(), scores.float()[:, None]]
    if classes is not None:
        parts.append(classes.float()[:, None] * CLASS_SCALE)
    return torch.cat(parts, dim=1)


def candidate_rows(cand_boxes: torch.Tensor, cand_scores: torch.Tensor,
                   with_class: bool) -> torch.Tensor:
    """Every (item, class) candidate of one frame: boxes (N, K, 7), scores
    (N, K) -> (N K, 8 or 9) rows (class 0-based)."""
    n, k = cand_scores.shape
    cls = torch.arange(k, device=cand_boxes.device).expand(n, k).reshape(-1)
    return box_rows(cand_boxes.reshape(n * k, 7), cand_scores.reshape(-1),
                    cls if with_class else None)


class Numbers:
    """Running widest gaps and set-gap shares over the judged frames."""

    def __init__(self):
        self.gaps: Dict[str, float] = {}
        self.sets: Dict[str, List[int]] = {}

    def gap(self, name: str, value: float) -> None:
        self.gaps[name] = max(self.gaps.get(name, 0.0), float(value))

    def set(self, name: str, missing: int, total: int) -> None:
        m, t = self.sets.get(name, [0, 0])
        self.sets[name] = [m + missing, t + total]

    def values(self) -> Dict[str, float]:
        out = dict(self.gaps)
        for name, (m, t) in self.sets.items():
            out[name] = m / t if t else 1.0
        return out


def judge_stage1(nums: Numbers, prefix: str, prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 match_tol: float) -> None:
    """The program's proposals (B, n, 7) and scores (B, n) (0 on padding
    rows) against the reference RPN's candidates (every point's box of
    each class with its foreground softmax) and its own keep set."""
    for f in range(prog["proposals"].shape[0]):
        valid = prog["proposal_scores"][f] > 0
        rows = box_rows(prog["proposals"][f][valid], prog["proposal_scores"][f][valid])
        cands = candidate_rows(ref["candidate_boxes"][f], ref["seg_softmax"][f, :, 1:], False)
        gaps = nearest_gaps(rows, cands)
        nums.gap(prefix + "_gap", gaps.max() if gaps.numel() else 0.0)
        kept = ref["proposal_valid"][f]
        ref_rows = box_rows(ref["proposals"][f][kept], ref["proposal_scores"][f][kept])
        nums.set(prefix + "_set_gap", *set_gap_counts(rows, ref_rows, match_tol))


def judge_stage2(nums: Numbers, prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 match_tol: float) -> None:
    """The program's final boxes, scores and classes against the reference
    RCNN's candidates (each of its proposals' box of each class with its
    softmax) and its own final keep set, the reference's RCNN run over the
    reference's own proposals."""
    for f in range(prog["final_boxes"].shape[0]):
        valid = prog["final_valid"][f].bool()
        rows = box_rows(prog["final_boxes"][f][valid], prog["final_scores"][f][valid],
                        prog["final_classes"][f][valid])
        cands = candidate_rows(ref["candidate_boxes"][f], ref["cls_softmax"][f, :, 1:], True)
        gaps = nearest_gaps(rows, cands)
        nums.gap("stage2_gap", gaps.max() if gaps.numel() else 0.0)
        if int(prog["num_final"][f]) != int(valid.sum()):
            nums.gap("stage2_gap", float("inf"))
        kept = ref["final_valid"][f].bool()
        ref_rows = box_rows(ref["final_boxes"][f][kept], ref["final_scores"][f][kept],
                            ref["final_classes"][f][kept])
        nums.set("stage2_set_gap", *set_gap_counts(rows, ref_rows, match_tol))


def judge_seg(nums: Numbers, prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> None:
    """The widest gap of the program's segmentation softmax."""
    nums.gap("seg_gap", (prog["seg_softmax"].float() - ref["seg_softmax"]).abs().max())


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Per leaf, the gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger."""
    norms = {n: float(ref[n].double().norm()) for n in leaves}
    med = sorted(norms.values())[len(norms) // 2] if norms else 0.0
    out = {}
    for n in leaves:
        got = float(prog[n].double().norm())
        out[n] = abs(got - norms[n]) / max(norms[n], med, 1e-30)
    return out


def moving_leaves(grads: Dict[str, torch.Tensor], share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: its
    norm at least `share` of the median leaf's. (A bias followed by a
    training BatchNorm has a gradient of 0 in exact arithmetic; Adam
    turns its rounding into updates of either sign.)"""
    norms = {n: float(g.double().norm()) for n, g in grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [n for n, v in norms.items() if v >= share * med]


def limits_line(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, List[float]]:
    """{name: [number, limit]} for the result line."""
    return {n: [numbers[n], limits[n]] for n in limits}


def passes(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number present, finite and within its limit."""
    return all(n in numbers and numbers[n] == numbers[n] and numbers[n] <= lim
               for n, lim in limits.items())
