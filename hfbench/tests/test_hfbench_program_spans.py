"""The program's own spans (`hfr.*`) in a traced run's record, on the CPU.

- A synthetic profile (`prof.events()` of host operators, runtime calls,
  kernels and the benchmark's spans) read with and without the program's
  operator-scoped `hfr.*` host events: the device readers (`device_idle`,
  `launches_per_step`, `xconv_roofline`) and the busy time read the same,
  and an idle gap that only the benchmark's span labelled now names the
  program's span open at that moment.
- `host_syncs` and `optimizer_launches` on hand-made records, and None
  where the record holds no program span (a program without them).
- A real CPU profile of the port's tracer: its spans land in `ops`.
"""

from __future__ import annotations

import types

import pytest
import torch
from torch.autograd import DeviceType

import hfbench_cells  # noqa: F401  (puts the repository on sys.path)
from hfbench import harness
from hfbench.trace import breakdown, busy_and_gaps, read_profile

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _event(name, start, end, device=CPU):
    return types.SimpleNamespace(name=name, device_type=device,
                                 time_range=types.SimpleNamespace(start=start, end=end))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


# One traced serving batch, us on the profiler's clock: the benchmark's
# window and spans (each with its copy on the device's timeline, as a
# user-scoped range has), the host's operators and launches, the kernels.
BASE = [
    _event("hfbench.traced_window", 0, 100),
    _event("hfbench.traced_window", 2, 98, CUDA),
    _event("hfbench.rpn", 1, 60),
    _event("hfbench.rpn", 5, 55, CUDA),
    _event("aten::conv2d", 2, 10),
    _event("cudaLaunchKernel", 3, 4),
    _event("sm80_xmma_fprop_implicit_gemm", 5, 20, CUDA),
    _event("aten::mm", 30, 35),
    _event("cudaLaunchKernel", 31, 32),
    _event("xconv_kernel<8>", 40, 55, CUDA),
    _event("cudaStreamSynchronize", 56, 59),
    _event("Memcpy DtoH (Device -> Pageable)", 58, 59, CUDA),
    _event("hfbench.rcnn", 61, 99),
    _event("cudaLaunchKernel", 62, 63),
    _event("xconv_kernel<4>", 70, 90, CUDA),
]
# The program's spans over the same batch: host events only.
PROGRAM = [
    _event("hfr.two_stage", 1, 99),
    _event("hfr.rpn", 1, 60),
    _event("hfr.rpn.img_vgg", 2, 11),
    _event("hfr.rpn.head", 12, 59),
    _event("hfr.rcnn", 61, 99),
    _event("hfr.rcnn.pc_encoder", 62, 98),
]


def _run(events):
    cfg = harness.load_json(harness.REPO + "/hfbench/configs/pointcnn_multiclass_f32.json")
    record = read_profile(_Prof(events))
    return {"window": {"trace": record, "batch": 16}, "traced_iterations": 1,
            "model": "two_stage", "configs": harness.reference_configs(cfg)}


def _read(metric, run):
    return harness.reader(metric).read(run)


def test_program_spans_leave_the_device_readers_as_they_were():
    without, with_spans = _run(BASE), _run(BASE + PROGRAM)
    assert with_spans["window"]["trace"]["device"] == without["window"]["trace"]["device"]
    assert busy_and_gaps(with_spans["window"]["trace"]) == busy_and_gaps(without["window"]["trace"])
    for metric in ("device_idle.serve", "launches_per_step.train", "xconv_roofline.serve"):
        assert _read(metric, with_spans) == _read(metric, without), metric
    names = {n for n, _, _ in with_spans["window"]["trace"]["ops"]}
    assert {"hfr.two_stage", "hfr.rpn.head"} <= names


def test_idle_gaps_name_the_program_span():
    """Each idle gap opens while no operator is open: the benchmark's spans
    alone say only `rpn` or `rcnn`; the program's innermost open span
    names the layer, and the idle time is the same."""
    def gaps(events):
        return {n: v for n, v in breakdown(_run(events)["window"]["trace"])["idle_gaps"]}

    assert gaps(BASE) == pytest.approx({"rpn": 34e-6, "rcnn": 10e-6, "outside spans": 5e-6})
    assert gaps(BASE + PROGRAM) == pytest.approx({
        "rpn / hfr.rpn.head": 23e-6, "rpn / hfr.rpn": 11e-6,
        "rcnn / hfr.rcnn.pc_encoder": 10e-6, "outside spans": 5e-6})


def _record(ops):
    return {"window": {"trace": {"device": [], "spans": [], "ops": ops, "window": (0, 1000)}}}


def test_host_syncs_counts_waits_inside_the_outermost_spans():
    ops = [
        ("hfr.two_stage", 10, 100), ("hfr.rpn", 10, 50), ("hfr.rpn.nms", 20, 30),
        ("cudaStreamSynchronize", 25, 26), ("cudaMemcpyAsync", 27, 28),
        ("cudaMemcpy", 40, 41), ("cudaEventRecord", 42, 43),
        ("hfr.two_stage", 200, 300), ("cudaDeviceSynchronize", 250, 251),
        ("cudaEventSynchronize", 260, 261),
        ("cudaStreamSynchronize", 150, 151),  # between forwards: the entry's
    ]
    assert _read("host_syncs.serve", _record(ops)) == 2.0
    # A child that starts with its parent and comes first in the profile's
    # events: the parent is still the root.
    tie = [("hfr.rpn", 10, 50), ("hfr.two_stage", 10, 100), ("hfr.rcnn", 50, 100),
           ("cudaStreamSynchronize", 20, 21), ("cudaStreamSynchronize", 70, 71)]
    assert _read("host_syncs.serve", _record(tie)) == 2.0
    assert _read("host_syncs.train", _record([
        ("hfr.train.step", 0, 100), ("hfr.train.backward", 10, 50),
        ("cudaStreamSynchronize", 60, 61)])) == 1.0


def test_optimizer_launches_counts_launches_inside_the_optimizer_span():
    ops = [
        ("hfr.train.step", 0, 1000), ("hfr.train.forward", 0, 100),
        ("cudaLaunchKernel", 50, 51),
        ("hfr.train.optimizer", 500, 600), ("hfr.optimizer.clip", 500, 520),
        ("cudaLaunchKernel", 505, 506), ("cudaLaunchKernelExC", 530, 531),
        ("cuLaunchKernel", 540, 541), ("cudaMemsetAsync", 550, 551),
        ("hfr.train.step", 1000, 2000), ("hfr.train.optimizer", 1500, 1600),
        ("cudaLaunchKernel", 1550, 1551),
    ]
    assert _read("optimizer_launches.train", _record(ops)) == 2.0


def test_readers_without_program_spans_return_none():
    """The parent's record: no `hfr.` span. And a run with no trace."""
    ops = [("aten::mm", 0, 5), ("cudaLaunchKernel", 1, 2), ("cudaStreamSynchronize", 3, 4)]
    for metric in ("host_syncs.serve", "host_syncs.train", "optimizer_launches.train"):
        assert _read(metric, _record(ops)) is None
        assert _read(metric, {"window": {"trace": None}}) is None


def test_the_tracer_spans_land_in_ops():
    """A CPU profile of the port's tracer, read as a traced window is."""
    from torch.profiler import ProfilerActivity, profile

    from heterofusionrcnn_torch.runtime import tracing
    from hfbench import trace

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("traced_window"):
            with tracing.span("train.step"):
                with tracing.span("train.optimizer"):
                    torch.ones(4) + 1
    rec = read_profile(prof)
    names = [n for n, _, _ in rec["ops"]]
    assert "hfr.train.step" in names and "hfr.train.optimizer" in names
    assert not any(n.startswith("hfr.") for n, _, _ in rec["device"])
    assert _read("host_syncs.train", {"window": {"trace": rec}}) == 0.0
    assert _read("optimizer_launches.train", {"window": {"trace": rec}}) == 0.0
