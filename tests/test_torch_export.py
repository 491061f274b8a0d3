"""The port's export (`runtime/export.py`) and its custom ops on the CPU.

- A tiny module through `export_fused_inference` / `load_exported`: the
  loaded program reproduces the live outputs (the JAX package's
  tests/test_runtime_extras.py round trip).
- The `rpn_unittest` / `rcnn_unittest` two-stage detector, both kernel
  switches on so that its graph calls every op of `torch.ops.hfr`,
  exported on one batch, saved, loaded, and called on another: equal to
  the eager forward on that batch (the same CPU ops, so within 1e-6; the
  kept indices, classes and counts exact) and different from the outputs
  for the trace batch (tests/test_parallel_extras.py: nothing is baked
  in). Its loaded outputs against the JAX fused function from the same
  weights at tests/test_torch_models.py's tolerances (features and scores
  1e-4, boxes 1e-3 end to end; classes, masks and counts exact).
- Each custom op's fake function gives the shapes and dtypes its CPU
  implementation returns.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from heterofusionrcnn_torch.configs import presets as torch_presets
from heterofusionrcnn_torch.convert import load_flax_variables
from heterofusionrcnn_torch.inference import TwoStageDetector, build_two_stage, random_batch
from heterofusionrcnn_torch.models.extractors.pointcnn import XConv
from heterofusionrcnn_torch.ops import library
from heterofusionrcnn_torch.runtime.export import export_fused_inference, load_exported

from tests.test_torch_layers import direct_knn
from tests.test_torch_models import _close, _inputs, _rcnn_jax, _rpn_pair

KEYS = ("proposals", "proposal_scores", "final_boxes", "final_scores", "final_classes",
        "final_valid", "num_final")
EXACT = ("final_classes", "final_valid", "num_final")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test (tests/test_torch_evaluator.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        rng = np.random.default_rng(0)
        self.w = torch.nn.Parameter(torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)))
        self.b = torch.nn.Parameter(torch.ones(3))

    def forward(self, pc, img, p2):
        return {"out": pc @ self.w + self.b}


def test_export_roundtrip(tmp_path, monkeypatch):
    mod = _Tiny()
    pc = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 4)).astype(np.float32))
    img, p2 = torch.zeros(1), torch.zeros(1)
    path = str(tmp_path / "tiny.pt2")
    assert export_fused_inference(mod, pc, img, p2, path) > 0
    loaded = load_exported(path, device="cpu")
    torch.testing.assert_close(loaded(pc, img, p2)["out"], mod(pc, img, p2)["out"],
                               rtol=0, atol=1e-6)
    # The card unless the caller asks for the CPU; no substitute where it lacks.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_exported(path)


def _batch(seed):
    """rpn_unittest's synthetic batch with the cloud shrunk 4x about the
    camera (tests/test_torch_models.py `_inputs`)."""
    b = random_batch(torch_presets.rpn_unittest(), 2, seed=seed)
    b["point_cloud"][..., :3] *= 0.25
    return tuple(torch.from_numpy(b[k]) for k in ("point_cloud", "image_input", "stereo_calib_p2"))


def _graph_ops(path):
    program = torch.export.load(path)
    return {str(n.target).split(".")[1] for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("hfr.")}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The JAX fused function's outputs on `_inputs()` and the port's
    detector from the same weights, both switches on, exported on another
    batch (seed 9)."""
    with pytest.MonkeyPatch.context() as mp:
        direct_knn(mp)
        _, rpn_want, rpn_v = _rpn_pair()
        rcnn_v, want = _rcnn_jax(rpn_want, True)
    rpn_cfg, rcnn_cfg = torch_presets.rpn_unittest(), torch_presets.rcnn_unittest()
    rcnn_cfg.model_config.rcnn_config.rcnn_use_rpn_img_feature_map = True
    det = TwoStageDetector(rpn_cfg, rcnn_cfg, conv_kernels=True, crop_kernel=True)
    load_flax_variables(det.rpn, rpn_v)
    load_flax_variables(det.rcnn, rcnn_v)
    det.eval()
    path = str(tmp_path_factory.mktemp("export") / "two_stage.pt2")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    size = export_fused_inference(det, *_batch(9), path)
    torch.set_num_threads(threads)
    want = dict(want, rpn_proposals=rpn_want["proposals"],
                rpn_proposal_scores=rpn_want["proposal_scores"])
    return det, path, size, want, load_exported(path, device="cpu")


def _new_inputs():
    return tuple(torch.from_numpy(np.asarray(_inputs()[k])) for k in (
        "point_cloud", "image_input", "stereo_calib_p2"))


def test_two_stage_export_equals_eager(exported):
    """The loaded artifact on a batch it was not traced on: the eager
    forward's outputs; on the trace batch: other outputs."""
    det, path, size, _, loaded = exported
    assert size > 0
    assert _graph_ops(path) == set(library.OPS) - {"xconv_split_epilogue"}
    new, traced = _new_inputs(), _batch(9)
    got, eager = loaded(*new), det(*new)
    assert set(got) == set(KEYS)
    for key in KEYS:
        if key in EXACT:
            torch.testing.assert_close(got[key], eager[key], rtol=0, atol=0)
        else:
            torch.testing.assert_close(got[key], eager[key], rtol=0, atol=1e-6)
    assert int(got["num_final"].min()) > 0
    other = loaded(*traced)
    assert not torch.allclose(other["final_boxes"], got["final_boxes"])
    assert not torch.allclose(other["proposals"], got["proposals"])


def test_two_stage_export_matches_jax(exported):
    """The loaded artifact against the JAX fused function (the RPN's
    proposals, then the RCNN on the shared stage-1 image map)."""
    _, _, _, want, loaded = exported
    got = loaded(*_new_inputs())
    np.testing.assert_array_equal(got["final_classes"].numpy(), want["final_classes"])
    np.testing.assert_array_equal(got["final_valid"].numpy(), want["final_valid"])
    np.testing.assert_array_equal(got["num_final"].numpy(), want["num_boxes_before_padding"])
    _close(got["proposals"], want["rpn_proposals"])
    _close(got["proposal_scores"], want["rpn_proposal_scores"])
    _close(got["final_scores"], want["final_scores"])
    _close(got["final_boxes"], want["final_boxes"], rtol=1e-3, atol=1e-3)


def _f32(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _op_cases():
    """Small CPU arguments for each op of `torch.ops.hfr`."""
    rng = np.random.default_rng(4)
    xyz = _f32(rng, 2, 40, 3, scale=5.0)
    qrs = _f32(rng, 2, 12, 3, scale=5.0)
    bev = torch.from_numpy(np.sort(rng.uniform(-4, 4, (2, 30, 2, 2)), axis=2)
                           .transpose(0, 1, 3, 2).reshape(2, 30, 4).astype(np.float32))
    bev = torch.cat([bev, _f32(rng, 2, 30, 1)], -1)
    xc = XConv(4, 1, 16, 8, 5, 2).eval()
    w = xc.weights()
    weights = [getattr(w, f) for f in w.__dataclass_fields__]
    idx = torch.from_numpy(rng.integers(0, 40, (2, 12, 4)).astype(np.int32))
    return {
        "knn": (xyz, qrs, 5, False, None),
        "knn_same_set": (xyz, xyz, 5, True, None),
        "farthest_point_sample": (xyz, 7),
        "oriented_nms": (bev, _f32(rng, 2, 30), 0.5, 9, torch.rand(2, 30) > 0.3),
        "fused_xconv": (xyz, _f32(rng, 2, 40, 5), qrs, idx, weights),
        "xconv_split_epilogue": (_f32(rng, 3, 10, 8), _f32(rng, 8), _f32(rng, 8)),
        "crop_gather": (_f32(rng, 2, 40, 8), idx[0], torch.tensor([0] * 6 + [1] * 6)),
        "conv3x3_affine_relu": (_f32(rng, 2, 3, 5, 7), _f32(rng, 4, 3, 3, 3), _f32(rng, 4),
                                _f32(rng, 4), True),
        "convtranspose3x3_affine_relu": (_f32(rng, 2, 3, 5, 7), _f32(rng, 3, 4, 3, 3),
                                         _f32(rng, 4), _f32(rng, 4), False),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_fake_functions_give_the_cpu_shapes(case):
    args = _op_cases()[case]
    op = getattr(torch.ops.hfr, case.replace("_same_set", ""))
    assert case.replace("_same_set", "") in library.OPS
    got = op(*args)

    def meta(a):
        if isinstance(a, torch.Tensor):
            return a.to("meta")
        if isinstance(a, list):
            return [meta(t) for t in a]
        return a

    fake = op(*(meta(a) for a in args))
    got, fake = (t if isinstance(t, tuple) else (t,) for t in (got, fake))
    assert len(got) == len(fake)
    for g, f in zip(got, fake):
        assert f.device.type == "meta"
        assert (g.shape, g.dtype) == (f.shape, f.dtype), case


def test_two_stage_bf16_export_on_cpu(tmp_path):
    """The `*_unittest` detector in bf16 (`compute_dtype="bfloat16"`), both
    switches on, through `torch.export` on the CPU: the graph calls the
    kernels' ops, whose fake functions give bf16 features, and the loaded
    artifact equals the eager forward bit for bit on another batch (the
    same CPU ops in the same order)."""
    det, inputs = build_two_stage(2, 5, "cpu", torch_presets.rpn_unittest(),
                                  torch_presets.rcnn_unittest(), conv_kernels=True,
                                  crop_kernel=True, compute_dtype="bfloat16")
    assert det.rpn.dtype == det.rcnn.dtype == torch.bfloat16
    path = str(tmp_path / "two_stage_bf16.pt2")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        export_fused_inference(det, *inputs, path)
        loaded = load_exported(path, device="cpu")
        new = _batch(6)
        got, want = loaded(*new), det(*new)
    finally:
        torch.set_num_threads(threads)
    assert {"fused_xconv", "crop_gather", "conv3x3_affine_relu",
            "convtranspose3x3_affine_relu"} <= _graph_ops(path)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)
    assert want["final_boxes"].dtype == torch.float32
    assert int(want["num_final"].min()) > 0
