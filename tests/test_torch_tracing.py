"""The port's tracer (`heterofusionrcnn_torch/runtime/tracing.py`) on the CPU.

- Off (the default): `span` returns one shared null context and nothing is
  recorded.
- After `enable()`: spans in the order they open, each with its parent and
  its request (the number of its outermost span), handed back and cleared
  by `collect()`; `host_ms` sums them by name a request.
- `spanned` wraps a method in its span and keeps its name and signature.
- Under a `torch.profiler`: each span is an operator-scoped `hfr.<name>`
  host event (no user annotation, so no copy on a device's timeline).
- The `rpn_unittest` / `rcnn_unittest` two-stage detector records the
  serving span tree, and `make_rpn_train_step` the train step's, with the
  same outputs as untraced; no span adds a tensor op, recording or not.
- On a card (marker `cuda`): a profile of a span around a kernel holds no
  `hfr.` event on the device's timeline.
"""

from __future__ import annotations

import contextlib
import inspect

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from heterofusionrcnn_torch.configs import presets as torch_presets
from heterofusionrcnn_torch.datasets.kitti.dataset import KittiDataset
from heterofusionrcnn_torch.inference import CLUSTER_SIZES, build_two_stage
from heterofusionrcnn_torch.models.extractors.layers import init_weights
from heterofusionrcnn_torch.models.rpn import RpnModel, rpn_loss
from heterofusionrcnn_torch.runtime import tracing
from heterofusionrcnn_torch.runtime.optimizer import build_optimizer
from heterofusionrcnn_torch.runtime.train_state import (
    RPN_BATCH_KEYS,
    TrainState,
    make_rpn_train_step,
)

SERVING_TREE = {
    "two_stage": None,
    "rpn": "two_stage",
    "rpn.pc_extractor": "rpn",
    "rpn.img_vgg": "rpn",
    "rpn.head": "rpn",
    "rpn.proposals": "rpn",
    "rpn.nms": "rpn.proposals",
    "rcnn": "two_stage",
    "rcnn.img_crop": "rcnn",
    "rcnn.pc_crop": "rcnn",
    "rcnn.pc_encoder": "rcnn",
    "rcnn.head": "rcnn",
    "rcnn.final_boxes": "rcnn",
    "rcnn.nms": "rcnn.final_boxes",
}
TRAIN_TREE = {
    "train.step": None,
    "train.forward": "train.step",
    "rpn": "train.forward",
    "rpn.pc_extractor": "rpn",
    "rpn.img_vgg": "rpn",
    "rpn.head": "rpn",
    "rpn.targets": "rpn",
    "train.loss": "train.step",
    "train.backward": "train.step",
    "train.optimizer": "train.step",
    "optimizer.clip": "train.optimizer",
    "optimizer.update": "train.optimizer",
    "optimizer.ema": "train.optimizer",
}


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every test starts and ends with the tracer off."""
    tracing.enable(False)
    yield
    tracing.enable(False)


def _tree(spans):
    """{name: parent's name} of a recorded list (each name once)."""
    names = [s["name"] for s in spans]
    assert len(names) == len(set(names)), names
    return {s["name"]: None if s["parent"] is None else spans[s["parent"]]["name"]
            for s in spans}


class _OpCount(TorchDispatchMode):
    """The aten operators a block runs, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def test_off_is_one_null_context_and_records_nothing():
    a, b = tracing.span("rpn"), tracing.span("rcnn.nms")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:
        pass
    assert tracing.collect() == {"spans": []}


def test_spans_order_parents_and_requests():
    tracing.enable()
    for _ in range(2):
        with tracing.span("two_stage"):
            with tracing.span("rpn"):
                with tracing.span("rpn.nms"):
                    pass
            with tracing.span("rcnn"):
                pass
    with tracing.span("rpn"):
        pass
    spans = tracing.collect()["spans"]
    assert [s["name"] for s in spans] == ["two_stage", "rpn", "rpn.nms", "rcnn"] * 2 + ["rpn"]
    assert [s["parent"] for s in spans] == [None, 0, 1, 0, None, 4, 5, 4, None]
    assert [s["request"] for s in spans] == [0] * 4 + [1] * 4 + [2]
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
    # collect() cleared the spans; the request numbers go on.
    with tracing.span("rcnn"):
        pass
    assert [(s["name"], s["request"]) for s in tracing.collect()["spans"]] == [("rcnn", 3)]


def test_host_ms_sums_each_name_a_request():
    def rec(name, start_ms, end_ms, request):
        return {"name": name, "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6),
                "parent": None, "request": request}

    spans = [rec("two_stage", 0, 10, 0), rec("rpn.nms", 1, 2, 0), rec("rpn.nms", 3, 5, 0),
             rec("two_stage", 20, 26, 1), rec("rpn.nms", 21, 22, 1)]
    assert tracing.host_ms(spans) == pytest.approx({"two_stage": 8.0, "rpn.nms": 2.0})
    assert list(tracing.host_ms(spans)) == ["two_stage", "rpn.nms"]
    assert tracing.host_ms([]) == {}


def test_spanned_keeps_the_method_and_opens_its_span():
    class Model(torch.nn.Module):
        @tracing.spanned("rpn")
        def forward(self, x, scale=2):
            """Doubles."""
            with tracing.span("rpn.head"):
                return x * scale

    m = Model()
    assert Model.forward.__name__ == "forward" and Model.forward.__doc__ == "Doubles."
    assert list(inspect.signature(m.forward).parameters) == ["x", "scale"]
    assert list(inspect.signature(RpnModel.forward).parameters)[:4] == [
        "self", "pc_input", "img_input", "calib_p2"]
    assert float(m(torch.ones(1))[0]) == 2.0  # off
    tracing.enable()
    assert float(m(torch.ones(1), scale=3)[0]) == 3.0
    assert _tree(tracing.collect()["spans"]) == {"rpn": None, "rpn.head": "rpn"}


def test_collect_inside_a_span_raises():
    tracing.enable()
    with tracing.span("train.step"):
        with pytest.raises(RuntimeError, match="train.step"):
            tracing.collect()


def test_profiler_sees_operator_scoped_hfr_events():
    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("rpn"):
            with tracing.span("rpn.nms"):
                x + 1
    events = {e.name: e for e in prof.events() if e.name.startswith(tracing.PREFIX)}
    assert set(events) == {"hfr.rpn", "hfr.rpn.nms"}
    outer, inner = events["hfr.rpn"], events["hfr.rpn.nms"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    for e in events.values():
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not getattr(e, "is_user_annotation", False)
    # Nothing recorded in memory: only enable() does that.
    assert tracing.collect() == {"spans": []}


def _two_stage(shared_vgg):
    rpn_cfg, rcnn_cfg = torch_presets.rpn_unittest(), torch_presets.rcnn_unittest()
    det, inputs = build_two_stage(2, 5, "cpu", rpn_cfg, rcnn_cfg)
    det.shared_vgg = shared_vgg
    return det, inputs


@pytest.mark.parametrize("shared_vgg", [True, False])
def test_two_stage_span_tree(shared_vgg):
    det, inputs = _two_stage(shared_vgg)
    want = det(*inputs)
    tracing.enable()
    got = det(*inputs)
    rec = tracing.collect()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    tree = dict(SERVING_TREE)
    if not shared_vgg:
        tree["rcnn.img_vgg"] = "rcnn"
    assert _tree(rec["spans"]) == tree
    assert {s["request"] for s in rec["spans"]} == {0}


def test_spans_add_no_tensor_op():
    """The forward's aten operators: the same off, under a profiler and
    recording."""
    det, inputs = _two_stage(True)

    def ops():
        with _OpCount() as count:
            det(*inputs)
        return count.ops

    det(*inputs)  # caches filled (the XConv's folded weights)
    off = ops()
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = ops()
    tracing.enable()
    recorded = ops()
    assert profiled == off
    assert recorded == off


def _train_batch():
    cfg = torch_presets.rpn_unittest()
    ds = KittiDataset(cfg.dataset_config, "train")
    ds.seed(0)
    ic = cfg.model_config.input_config
    batch, _ = ds.next_batch(2, shuffle=True, model="rpn", pc_sample_pts=ic.pc_sample_pts,
                             img_w=ic.img_dims_w, img_h=ic.img_dims_h)
    return cfg, {k: torch.from_numpy(np.asarray(batch[k])) for k in RPN_BATCH_KEYS}


def test_train_step_span_tree():
    cfg, batch = _train_batch()
    mc, tc = cfg.model_config, cfg.train_config
    tc.optimizer.use_moving_average = True
    model = init_weights(RpnModel(mc, len(CLUSTER_SIZES), CLUSTER_SIZES, save_rpn_feature=False,
                                  mode="train"), 0)
    opt = build_optimizer(model, tc.optimizer, grad_clip_norm=tc.grad_clip_norm)
    assert opt.ema is not None
    state = TrainState.create(model, opt, 0)
    step = make_rpn_train_step(lambda preds: rpn_loss(preds, mc))
    tracing.enable()
    metrics = [step(state, batch) for _ in range(2)]
    rec = tracing.collect()
    assert all(torch.isfinite(m["total_loss"]) for m in metrics)
    first = [s for s in rec["spans"] if s["request"] == 0]
    assert _tree(first) == TRAIN_TREE
    assert [s["name"] for s in first if s["parent"] == 0] == [
        "train.forward", "train.loss", "train.backward", "train.optimizer"]
    assert [s["request"] for s in rec["spans"]] == [0] * len(first) + [1] * len(first)


@pytest.mark.cuda
def test_no_device_copy_of_a_span_on_the_card():
    """On a card: the profile's device timeline holds the kernel and no
    `hfr.` event (a user-scoped `record_function` range would add one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracing.span("rpn.nms"):
            y = x * 2
        torch.cuda.synchronize()
    assert float(y[0]) == 2.0
    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any(e.name == "hfr.rpn.nms" for e in cpu)
    assert dev and not any(e.name.startswith(tracing.PREFIX) for e in dev)
