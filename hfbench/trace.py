"""What a `--trace 1` run records: the device's kernels under
torch.profiler over a few iterations of the window, CUDA events around
the program's layers (forward hooks on its modules), and the benchmark's
own spans (`record_function`) around the calls into each layer.

All of it comes from the benchmark's files: the program has no spans of
its own yet. The readers in `hfbench/metrics/` turn the records into
metrics; this module only records and does interval arithmetic.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# Span names of the benchmark's own spans start with this.
SPAN_PREFIX = "hfbench."
# Device activity that is not a kernel launch.
_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def span(name: str):
    """A benchmark span around a call into the program."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class ModuleTimer:
    """CUDA events before and after every call of each named module, and a
    benchmark span around it. `per_iteration()` gives each module's device
    ms of every iteration marked with `mark()`."""

    def __init__(self, modules: Dict[str, torch.nn.Module], enabled: bool):
        self.names = list(modules)
        self.calls: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = {
            n: [] for n in self.names}
        self.marks: List[Dict[str, int]] = []
        self._open: Dict[str, list] = {n: [] for n in self.names}
        self._handles = []
        if not enabled:
            return
        for name, mod in modules.items():
            self._handles.append(mod.register_forward_pre_hook(self._pre(name)))
            self._handles.append(mod.register_forward_hook(self._post(name)))

    def _pre(self, name):
        def hook(module, args):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rf = span(name)
            rf.__enter__()
            self._open[name].append((start, rf))
        return hook

    def _post(self, name):
        def hook(module, args, out):
            start, rf = self._open[name].pop()
            rf.__exit__(None, None, None)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.calls[name].append((start, end))
        return hook

    def mark(self) -> None:
        """Close an iteration: the calls made since the last mark are its."""
        self.marks.append({n: len(self.calls[n]) for n in self.names})

    def per_iteration(self, iterations: Sequence[int]) -> Dict[str, List[float]]:
        """{module: [device ms of each of `iterations`]} (synchronise first)."""
        out = {}
        for n in self.names:
            ms = []
            for i in iterations:
                lo = self.marks[i - 1][n] if i > 0 else 0
                hi = self.marks[i][n]
                ms.append(sum(s.elapsed_time(e) for s, e in self.calls[n][lo:hi]))
            out[n] = ms
        return out

    def close(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


class DeviceTrace:
    """torch.profiler over iterations [start, start + count) of the window."""

    def __init__(self, start: int, count: int, enabled: bool):
        self.start, self.count, self.enabled = start, count, enabled
        self.prof = None
        self._span = None
        self.record: Optional[dict] = None

    @property
    def iterations(self) -> range:
        return range(self.start, self.start + self.count) if self.enabled else range(0)

    def before(self, i: int) -> None:
        """Call before iteration i."""
        if self.enabled and i == self.start:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._span = span("traced_window")
            self._span.__enter__()

    def after(self, i: int) -> None:
        """Call after iteration i (its outputs on the host)."""
        if self.prof is not None and i == self.start + self.count - 1:
            torch.cuda.synchronize()
            self._span.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.record = read_profile(self.prof)
            self.prof = None

    @property
    def done(self) -> bool:
        return not self.enabled or self.record is not None


def read_profile(prof) -> dict:
    """Device intervals, host spans and the traced window (us on the
    profiler's clock) from a finished profile."""
    from torch.autograd import DeviceType

    device, spans, ops = [], [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith(SPAN_PREFIX):
            # A span shows on the device's timeline too (as a GPU user
            # annotation): that copy is no device activity.
            if e.device_type == DeviceType.CPU:
                spans.append((e.name[len(SPAN_PREFIX):], start, end))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, start, end))
        elif e.device_type == DeviceType.CPU:
            ops.append((e.name, start, end))
    window = [s for s in spans if s[0] == "traced_window"]
    if not window:
        raise RuntimeError("the profile holds no traced window span")
    _, w0, w1 = window[0]
    return {"device": device, "spans": [s for s in spans if s[0] != "traced_window"],
            "ops": ops, "window": (w0, w1)}


def union(intervals: Sequence[Tuple[float, float]], lo: float, hi: float):
    """The union of intervals clipped to [lo, hi], as sorted disjoint pairs."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_and_gaps(record: dict):
    """(busy us, idle gaps [(start, end)]) of the device over the window."""
    w0, w1 = record["window"]
    busy = union([(s, e) for _, s, e in record["device"]], w0, w1)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = e
    if t < w1:
        gaps.append((t, w1))
    return sum(e - s for s, e in busy), gaps


def kernels(record: dict):
    """The device events that are kernel launches (no copies or sets)."""
    return [d for d in record["device"] if not d[0].startswith(_NOT_KERNELS)]


def _innermost(items: List[Tuple[str, float, float]], starts: List[float], t: float,
               reach: int = 256) -> Optional[str]:
    """The latest-starting of `items` (sorted by start) open at time t,
    looking back at most `reach` items."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        name, s, e = items[j]
        if s <= t < e:
            return name
    return None


def breakdown(record: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing when each gap began (the innermost benchmark span
    open then and the innermost operator inside it), seconds over the
    traced window."""
    by_op: Dict[str, float] = {}
    for name, s, e in record["device"]:
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6
    spans = sorted(record["spans"], key=lambda x: x[1])
    ops = sorted(record["ops"], key=lambda x: x[1])
    span_starts, op_starts = [s for _, s, _ in spans], [s for _, s, _ in ops]
    _, gaps = busy_and_gaps(record)
    by_host: Dict[str, float] = {}
    for s, e in gaps:
        sp = _innermost(spans, span_starts, s) or "outside spans"
        op = _innermost(ops, op_starts, s)
        label = f"{sp} / {op}" if op else sp
        by_host[label] = by_host.get(label, 0.0) + (e - s) * 1e-6
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], v] for n, v in top_ops],
            "idle_gaps": [[n[:200], v] for n, v in idle]}
