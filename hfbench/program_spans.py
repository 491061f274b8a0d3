"""The program's own spans in a `--trace 1` run's record.

The port opens a profiler range `hfr.<span>` around each layer's work
(`heterofusionrcnn_torch/runtime/tracing.py`: `hfr.two_stage` around
`hfr.rpn` and `hfr.rcnn` in serving, `hfr.train.step` around
`hfr.train.forward`, `.loss`, `.backward` and `.optimizer` in training).
The ranges are operator-scoped host events, so `trace.read_profile` files
them under `ops`, beside the operators and the CUDA runtime calls, and the
device's timeline holds no copy of them. A program without spans has none
in its record, and the readers of these metrics then return None.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

PREFIX = "hfr."

Interval = Tuple[str, float, float]


def spans(record: dict, name: str = "") -> List[Interval]:
    """The program's spans in the record, (name without the prefix, start,
    end) sorted by start, a parent before a child that starts with it;
    only those named `name` if given."""
    out = [(n[len(PREFIX):], s, e) for n, s, e in record["ops"] if n.startswith(PREFIX)]
    if name:
        out = [x for x in out if x[0] == name]
    return sorted(out, key=lambda x: (x[1], -x[2]))


def roots(record: dict) -> List[Interval]:
    """The outermost program spans: one a forward or a train step."""
    out: List[Interval] = []
    for sp in spans(record):
        if not out or sp[1] >= out[-1][2]:
            out.append(sp)
    return out


def count_inside(record: dict, match: Callable[[str], bool], within: List[Interval]) -> int:
    """The host events (operators, runtime calls) whose name `match`es and
    which start inside one of the spans `within`."""
    return sum(1 for n, s, _ in record["ops"]
               if match(n) and any(a <= s < b for _, a, b in within))
