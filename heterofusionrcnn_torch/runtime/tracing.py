"""Spans inside the port, at its layer boundaries.

    from heterofusionrcnn_torch.runtime import tracing

    with tracing.span("rpn.nms"):          # a layer's work
        ...

    @tracing.spanned("rpn")                # a method's whole body
    def forward(self, ...):

Off is the default. A span is then one shared null context, returned
after a flag check and `torch.autograd._profiler_enabled()`: no tensor
op, no launch, nothing `torch.export` sees.

While a `torch.profiler` records (`run_training --profile_steps`, or any
profile an operator takes around the port), each span also opens a
profiler range named `hfr.<span>`, on the profiler's clock beside the
operators, the CUDA runtime calls and, through them, the kernels. In an
exported Chrome trace the `hfr.*` ranges sit on the host thread's row,
around the `aten::*` operators, the `hfr::<op>` custom ops and the
`cudaLaunchKernel` calls they made; a kernel's flow arrow leads back to
the launch inside them, and an idle stretch of the device's row falls
under the range open on the host at that moment. The ranges are
operator-scoped (`RecordScope::FUNCTION`), so the device's rows get no
copy of them: device-side tools see only the device's own work. The
`hfr::<op>` custom ops get no span of their own, as the dispatcher
already records each as an event.

`enable()` also keeps every span in memory (its name, its host start and
end from `time.perf_counter_ns`, the index of its parent, and the request:
the number of its outermost span since `enable()`, from 0, so every span
of the k-th forward or step carries k); `collect()` hands them back and
clears them, and `host_ms` sums them by name a request (`run_inference`
prints it for the frames it ran). Spans are recorded from one thread, the
one that calls the port.

Spans (their names are `<module>` or `<module>.<part>`):

- serving: `two_stage` (`inference.TwoStageDetector.forward`), around
  `rpn` and `rcnn` (each a root when its model is called alone);
  `rpn.pc_extractor`, `rpn.img_vgg`, `rpn.head`, `rpn.proposals` (around
  `rpn.nms`), `rpn.targets`; `rcnn.img_vgg` (only when the stage-1 image
  map is not shared), `rcnn.img_crop`, `rcnn.pc_crop`, `rcnn.pc_encoder`,
  `rcnn.head`, `rcnn.final_boxes` (around `rcnn.nms`), `rcnn.targets`;
- training (`runtime.train_state.train_step`): `train.step`, around
  `train.forward`, `train.loss`, `train.backward`, `train.all_reduce` (with
  a process group) and `train.optimizer`, around `optimizer.clip`,
  `optimizer.update` and `optimizer.ema`.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Optional

import torch

PREFIX = "hfr."
_NULL = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


class _Recorder:
    """What `enable()` keeps: spans in the order they open and the stack of
    open ones."""

    def __init__(self):
        self.spans: List[dict] = []
        self.open: List[int] = []
        self.requests = 0

    def push(self, name: str) -> dict:
        if self.open:
            parent = self.open[-1]
            request = self.spans[parent]["request"]
        else:
            parent, request = None, self.requests
            self.requests += 1
        rec = {"name": name, "start_ns": time.perf_counter_ns(), "end_ns": None,
               "parent": parent, "request": request}
        self.open.append(len(self.spans))
        self.spans.append(rec)
        return rec

    def pop(self, rec: dict) -> None:
        rec["end_ns"] = time.perf_counter_ns()
        self.open.pop()


_recorder: Optional[_Recorder] = None


class _Span:
    __slots__ = ("name", "range", "recorder", "rec")

    def __init__(self, name: str):
        self.name = name
        self.range = None
        self.recorder = _recorder
        self.rec = None

    def __enter__(self):
        if self.recorder is not None:
            self.rec = self.recorder.push(self.name)
        if _profiler_enabled():
            self.range = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.rec is not None:
            self.recorder.pop(self.rec)
        return False


def span(name: str):
    """A context manager around one layer's work: a shared null context
    unless `enable()` is on or a profiler records."""
    if _recorder is None and not _profiler_enabled():
        return _NULL
    return _Span(name)


def spanned(name: str):
    """A decorator that runs the whole function inside `span(name)`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def enable(on: bool = True) -> None:
    """Start keeping spans in memory (a fresh record, request numbers from
    0), or with `on=False` stop and drop them."""
    global _recorder
    _recorder = _Recorder() if on else None


def collect() -> dict:
    """{"spans": [...]} recorded since `enable()` or the last `collect()`,
    and clear them (recording stays on, request numbers go on). Each span:
    name, start_ns, end_ns, parent (its index in the list, None for a
    root), request. Call it outside every span."""
    rec = _recorder
    if rec is None:
        return {"spans": []}
    if rec.open:
        raise RuntimeError(f"collect() inside the open span {rec.spans[rec.open[-1]]['name']!r}")
    spans, rec.spans = rec.spans, []
    return {"spans": spans}


def host_ms(spans: List[dict]) -> Dict[str, float]:
    """Host ms of each span name in collected `spans`, summed over them and
    divided by the number of requests they hold, in the order the names
    first open."""
    if not spans:
        return {}
    total: Dict[str, int] = {}
    for s in spans:
        total[s["name"]] = total.get(s["name"], 0) + s["end_ns"] - s["start_ns"]
    requests = len({s["request"] for s in spans})
    return {name: ns / 1e6 / requests for name, ns in total.items()}
