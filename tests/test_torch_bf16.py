"""The bf16 serving path (`compute_dtype` "bfloat16") against the JAX package
in bf16, on the CPU, at small widths.

- Each kernel's plain bf16 version against the JAX Pallas function,
  interpreted, at `compute_dtype=jnp.bfloat16`: the fused XConv (both
  neighbour modes, with and without the X-transform), the 3x3 conv and the
  transposed conv, and the crop gather (bit for bit: a copy). The plain
  versions round to bf16 where the Pallas kernels cast to their compute
  dtype, so they agree to the bit but where two float32 sums in another
  order round to neighbouring bf16 values: at most one bf16 ulp
  (2^-7 |want|) an element, on a few elements, plus 2^-16 of the largest
  magnitude for sums that cancel to about 0.
- The XConv module in eval against the JAX `XConv(dtype=bfloat16)` on its
  fused path (`HFR_FUSED_XCONV_INTERPRET=1`); the VGG pyramid against JAX's
  on the XLA path and on the Pallas conv path
  (`HFR_PALLAS_CONV=1 HFR_PALLAS_CONV_INTERPRET=1`), op by op (eager), where
  flax rounds after every layer as the port does: within one ulp (and
  2^-12 of the largest magnitude, see `_within_ulps`).
- `RpnModel` (test and val mode), `RcnnModel` (given the JAX RPN's bf16
  proposals and stage-1 tensors) and the two-stage detector at
  `*_unittest` against the JAX models under `jax.jit` on their CPU path.
  XLA's fusions there drop some of flax's intermediate bf16 roundings (jit
  and eager JAX differ in many of the VGG map's elements), so one-ulp
  differences enter early and travel through the stacked layers: the
  features and heads before the top-k are held within BF16_MODEL_TOL, 2^-6
  |want| (two ulps where the spacing is coarsest) plus 1% of the tensor's
  largest magnitude (about 2.5 ulps at that magnitude). FPS and KNN run on
  the float32 points, so their indices are exact: the bf16 forward's calls
  equal the float32 forward's and the JAX functions' on the same points.
  Proposals and final boxes are compared as matched row sets (a bf16-level
  score difference can reorder near ties; each test states the share).
- Parameters stay float32 with the float32 model's state-dict keys, and
  train mode trains (tests/test_torch_bf16_training.py).

The float32 parity tests are untouched; the kernels themselves in bf16 run
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heterofusionrcnn_tpu.configs import presets as jax_presets
from heterofusionrcnn_tpu.configs.presets import rpn_unittest as jax_rpn_unittest
from heterofusionrcnn_tpu.models.extractors import img_vgg_pyr as j_vgg
from heterofusionrcnn_tpu.models.extractors import pointcnn as j_pointcnn
from heterofusionrcnn_tpu.models.rcnn import RcnnModel as JaxRcnn
from heterofusionrcnn_tpu.models.rpn import RpnModel as JaxRpn
from heterofusionrcnn_tpu.ops.pallas_conv import conv3x3_affine_relu as jax_conv
from heterofusionrcnn_tpu.ops.pallas_convtranspose import (
    convtranspose3x3_affine_relu as jax_convt,
)
from heterofusionrcnn_tpu.ops.pallas_crop import crop_gather as jax_crop_gather
from heterofusionrcnn_tpu.ops.pallas_knn import _knn_reference_jnp
from heterofusionrcnn_tpu.ops.pallas_xconv import fused_xconv as jax_fused_xconv
from heterofusionrcnn_tpu.ops.sampling import farthest_point_sample as jax_fps

from heterofusionrcnn_torch.configs import presets as torch_presets
from heterofusionrcnn_torch.convert import load_flax_variables
from heterofusionrcnn_torch.inference import CLUSTER_SIZES, TwoStageDetector
from heterofusionrcnn_torch.models.extractors import img_vgg_pyr as t_vgg
from heterofusionrcnn_torch.models.extractors import pointcnn as t_pointcnn
from heterofusionrcnn_torch.models.rcnn import RcnnModel
from heterofusionrcnn_torch.models.rpn import RpnModel
from heterofusionrcnn_torch.ops.conv import conv3x3_affine_relu, convtranspose3x3_affine_relu
from heterofusionrcnn_torch.ops.cropping import crop_gather
from heterofusionrcnn_torch.ops.grouping import knn_point
from heterofusionrcnn_torch.ops.xconv import fused_xconv

from tests.test_torch_cuda import _torch_weights, _xconv_params
from tests.test_torch_layers import as_jax, random_variables
from tests.test_torch_models import _inputs

BF16 = torch.bfloat16
ULP = 2.0 ** -7          # one bf16 ulp relative to |x| where the spacing is coarsest
BF16_MODEL_TOL = dict(rtol=2.0 ** -6, scale_share=0.01)
BOX_TOL = 0.05           # metres / radians for matched boxes (decoded from bf16-level heads)


def _np(x) -> np.ndarray:
    """A torch tensor or JAX array as float32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).detach().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _within_ulps(got, want, ulps=1, atol_share=2.0 ** -16):
    """|got - want| <= ulps * 2^-7 |want| + atol_share * max |want|
    everywhere; returns the share of elements that are not bit-equal. The
    absolute part covers results that cancel to about 0: for a kernel
    (2^-16, 1/256 of an ulp at the largest magnitude) a float32 sum in
    another order that comes out 0 on one side, or through a ReLU, and tiny
    on the other; for a module (2^-12) an intermediate bf16 rounding that
    flips by one ulp, its float32 input summed in another order, ahead of a
    BatchNorm shift that cancels the result."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    atol = atol_share * float(np.abs(want).max())
    np.testing.assert_array_less(np.abs(got - want), ulps * ULP * np.abs(want) + atol + 1e-30)
    return float(np.mean(got != want))


def _model_close(got, want, name=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    bound = BF16_MODEL_TOL["rtol"] * np.abs(want) + BF16_MODEL_TOL["scale_share"] * scale
    excess = np.abs(got - want) - bound
    assert excess.max() <= 0, f"{name}: {np.abs(got - want).max()} at scale {scale}"


def _matched_rows(got, want, valid, tol=BOX_TOL, share=1.0):
    """Each valid row of `want` (B, n, 7) has a valid row of `got` within
    `tol` in every coordinate, for at least `share` of the rows."""
    got, want, valid = _np(got), _np(want), np.asarray(valid).astype(bool)
    matched = total = 0
    for b in range(want.shape[0]):
        g = got[b][valid[b]]
        for row in want[b][valid[b]]:
            total += 1
            matched += bool(len(g)) and np.abs(g - row).max(-1).min() <= tol
    assert total > 0
    assert matched >= share * total, f"{matched} of {total} rows matched"


# --------------------------------------------------------------- kernels --


@pytest.mark.parametrize("with_x", [True, False], ids=["x", "no_x"])
@pytest.mark.parametrize("gather", ["in_kernel", "pre_gathered"])
def test_fused_xconv_bf16_plain_matches_pallas(with_x, gather):
    rng = np.random.default_rng(3)
    b, n, p, k, cf, cp, dm, d = 2, 40, 16, 8, 8, 6, 2, 16
    params = _xconv_params(rng, k, cf, cf + cp, dm, d)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    qrs = rng.standard_normal((b, p, 3)).astype(np.float32)
    fts = rng.standard_normal((b, n, cp)).astype(np.float32)
    idx = rng.integers(0, n, (b, p, k)).astype(np.int32)
    nn_local = np.take_along_axis(pts[:, None], idx[..., None], axis=2) - qrs[:, :, None]
    jp = {key: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else jnp.asarray(v))
          for key, v in params.items()}
    fts16 = jnp.asarray(fts).astype(jnp.bfloat16)
    if gather == "in_kernel":
        kw = dict(fts_src=fts16, nn_idx=jnp.asarray(idx))
        nn_fts_t = None
    else:
        kw = {}
        nn_fts_t = jnp.swapaxes(
            jnp.take_along_axis(fts16[:, None], jnp.asarray(idx)[..., None], axis=2), 1, 2)
    want = jax_fused_xconv(jnp.asarray(nn_local), nn_fts_t, jp, compute_dtype=jnp.bfloat16,
                           with_x_transformation=with_x, interpret=True, **kw)
    assert want.dtype == jnp.bfloat16
    got = fused_xconv(torch.from_numpy(pts), torch.from_numpy(fts).to(BF16),
                      torch.from_numpy(qrs), torch.from_numpy(idx),
                      _torch_weights(params, with_x), BF16)
    assert got.dtype == BF16 and got.shape == (b, p, d)
    _within_ulps(got, want)


CONV_SHAPES = [(1, 5, 7, 3, 8), (2, 9, 15, 32, 16), (1, 23, 75, 32, 40)]


def _conv_case(seed, b, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, w, cin)) * 3).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(BF16)
    return x, k, scale, shift, xt


@pytest.mark.parametrize("b,h,w,cin,cout", CONV_SHAPES)
def test_conv3x3_bf16_plain_matches_pallas(b, h, w, cin, cout):
    x, k, scale, shift, xt = _conv_case(10, b, h, w, cin, cout)
    want = jax_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(shift),
                    compute_dtype=jnp.bfloat16, interpret=True)
    got = conv3x3_affine_relu(xt, torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))),
                              torch.from_numpy(scale), torch.from_numpy(shift))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_ulps(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("b,h,w,cin,cout", CONV_SHAPES)
def test_convtranspose3x3_bf16_plain_matches_pallas(b, h, w, cin, cout):
    x, k, scale, shift, xt = _conv_case(11, b, h, w, cin, cout)
    want = jax_convt(jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(shift),
                     compute_dtype=jnp.bfloat16, interpret=True)
    wt = torch.from_numpy(np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1)))
    got = convtranspose3x3_affine_relu(xt, wt, torch.from_numpy(scale), torch.from_numpy(shift))
    assert got.dtype == BF16 and got.shape == (b, cout, 2 * h, 2 * w)
    _within_ulps(got.permute(0, 2, 3, 1), want)


def test_crop_gather_bf16_matches_pallas_bit_exact():
    rng = np.random.default_rng(0)
    b, n, c, nb, r = 2, 256, 48, 8, 32
    src = jnp.asarray(rng.standard_normal((b, n, c)).astype(np.float32)).astype(jnp.bfloat16)
    idx = rng.integers(0, n, (nb, r)).astype(np.int32)
    box_ind = np.repeat(np.arange(b), nb // b).astype(np.int32)
    want = jax_crop_gather(src, jnp.asarray(idx), jnp.asarray(box_ind), interpret=True)
    got = crop_gather(torch.from_numpy(_np(src)).to(BF16), torch.from_numpy(idx),
                      torch.from_numpy(box_ind))
    assert got.dtype == BF16
    np.testing.assert_array_equal(_np(got), _np(want))


# --------------------------------------------------------------- modules --


def test_xconv_module_bf16_matches_fused_jax(monkeypatch):
    """With the global branch (its DenseBNs in bf16) and 12 input features."""
    monkeypatch.setenv("HFR_FUSED_XCONV_INTERPRET", "1")
    with_global, cp = True, 12
    rng = np.random.default_rng(3)
    b, n, p, k = 2, 96, 32, 8
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    fts = rng.standard_normal((b, n, cp)).astype(np.float32)
    qrs = pts[:, :p]
    _, idx = knn_point(k, torch.from_numpy(pts), torch.from_numpy(qrs))
    mod = j_pointcnn.XConv(K=k, D=1, C=32, C_pts_fts=16, depth_multiplier=2,
                           with_global=with_global, dtype=jnp.bfloat16)
    args = (jnp.asarray(pts), jnp.asarray(fts), jnp.asarray(qrs), False)
    v = random_variables(
        lambda: mod.init(jax.random.PRNGKey(0), *args, nn_idx=jnp.asarray(idx.numpy())), 4)
    want = mod.apply(as_jax(v), *args, nn_idx=jnp.asarray(idx.numpy()))
    ours = t_pointcnn.XConv(k, 1, 32, 16, cp, 2, with_global=with_global, dtype=BF16)
    load_flax_variables(ours, v).eval()
    with torch.no_grad():
        got = ours(torch.from_numpy(pts), torch.from_numpy(fts), torch.from_numpy(qrs), idx)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert got.shape == (b, p, ours.out_channels)
    _within_ulps(got, want, atol_share=2.0 ** -12)


@pytest.mark.parametrize("path", ["xla", "pallas"])
def test_img_vgg_pyr_bf16_matches_jax(monkeypatch, path):
    if path == "pallas":
        monkeypatch.setenv("HFR_PALLAS_CONV", "1")
        monkeypatch.setenv("HFR_PALLAS_CONV_INTERPRET", "1")
    rng = np.random.default_rng(1)
    cfg = torch_presets.rpn_unittest().model_config.layers_config.img_vgg_pyr
    jcfg = jax_rpn_unittest().model_config.layers_config.img_vgg_pyr
    img = rng.uniform(0, 255, (1, 24, 40, 3)).astype(np.float32)
    mod = j_vgg.ImgVggPyr(jcfg, dtype=jnp.bfloat16)
    x = j_vgg.preprocess_image(jnp.asarray(img))
    v = random_variables(lambda: mod.init(jax.random.PRNGKey(0), x, False), 2)
    want = mod.apply(as_jax(v), x, False)
    ours = t_vgg.ImgVggPyr(cfg, conv_kernels=path == "pallas", dtype=BF16)
    load_flax_variables(ours, v).eval()
    with torch.no_grad():
        got = ours(t_vgg.preprocess_image(torch.from_numpy(img)))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_ulps(got, want, atol_share=2.0 ** -12)


# ---------------------------------------------------------------- models --


def _labels(seed=5):
    """Val-mode labels for `_inputs()`: per-point segmentation labels and
    regression boxes, and two GT boxes a frame."""
    pc = _inputs()["point_cloud"]
    b, p = pc.shape[:2]
    rng = np.random.default_rng(seed)
    segs = rng.integers(-1, 4, (b, p)).astype(np.int32)
    boxes = np.concatenate([
        pc[..., :3][:, :2] + rng.uniform(-1, 1, (b, 2, 3)),
        rng.uniform(1.0, 4.0, (b, 2, 3)), rng.uniform(-np.pi, np.pi, (b, 2, 1)),
    ], -1).astype(np.float32)
    regs = boxes[np.arange(b)[:, None], rng.integers(0, 2, (b, p))]
    return segs, regs.astype(np.float32), boxes


def _rpn_cfg(presets):
    cfg = presets.rpn_unittest().model_config
    cfg.compute_dtype = "bfloat16"
    return cfg


@functools.lru_cache(maxsize=None)
def _rpn_pair(mode):
    """The JAX RPN (bf16, `mode`, features saved) and the port's on the same
    weights and inputs; the port's FPS and KNN calls recorded."""
    model = JaxRpn(config=_rpn_cfg(jax_presets), num_classes=3, cluster_sizes=CLUSTER_SIZES,
                   mode=mode, save_rpn_feature=True)
    inp = _inputs()
    keys = ("point_cloud", "image_input", "stereo_calib_p2")
    args = [jnp.asarray(inp[k]) for k in keys]
    if mode == "val":
        args += [jnp.asarray(x) for x in _labels()]
    v = random_variables(lambda: model.init(jax.random.PRNGKey(0), *args, training=False), 7)
    head = v["params"]["fc_output"]["Dense_0"]  # boxes of positive size (test_torch_evaluator)
    head["kernel"] = head["kernel"] * np.float32(0.1)
    head["bias"] = head["bias"] * np.float32(0.1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_pointcnn, "knn_point", _knn_reference_jnp)
        want = jax.jit(lambda v_, *a: model.apply(v_, *a, training=False))(as_jax(v), *args)
    want = jax.tree_util.tree_map(np.asarray, want)

    ours = RpnModel(_rpn_cfg(torch_presets), 3, CLUSTER_SIZES, mode=mode)
    load_flax_variables(ours, v).eval()
    calls = {"fps": [], "knn": []}
    fps, knn = t_pointcnn.farthest_point_sample, t_pointcnn.knn_point

    def rec_fps(pts, n):
        out = fps(pts, n)
        calls["fps"].append((pts, n, out))
        return out

    def rec_knn(k, pts, qrs):
        out = knn(k, pts, qrs)
        calls["knn"].append((k, pts, qrs, out[1]))
        return out

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(t_pointcnn, "farthest_point_sample", rec_fps)
        mp.setattr(t_pointcnn, "knn_point", rec_knn)
        got = ours(*[torch.from_numpy(np.array(a)) for a in args])
    return got, want, v, calls


@pytest.mark.parametrize("mode", ["test", "val"])
def test_rpn_bf16_matches_jax(mode):
    got, want, _, calls = _rpn_pair(mode)
    for key in ("rpn_fts", "rpn_img_fts", "img_feature_map"):
        assert got[key].dtype == BF16 and want[key].dtype == jnp.bfloat16, key
        _model_close(got[key], want[key], key)
    for key in ("seg_logits", "seg_softmax"):
        assert got[key].dtype == torch.float32 and want[key].dtype == np.float32, key
        _model_close(got[key], want[key], key)
    np.testing.assert_array_equal(got["rpn_pts"].numpy(), want["rpn_pts"])
    assert (_np(got["seg_preds"]) != want["seg_preds"]).mean() < 0.01
    if mode == "val":
        # The heads at the GT class and bins, before any top-k.
        for g, w in zip(got["cls_preds"] + got["reg_preds"], want["cls_preds"] + want["reg_preds"]):
            _model_close(g, w, "val head")
        np.testing.assert_array_equal(_np(got["seg_gt_one_hot"]), want["seg_gt_one_hot"])
    np.testing.assert_array_equal(got["num_proposals_before_padding"].numpy(),
                                  want["num_proposals_before_padding"])
    _matched_rows(got["proposals"], want["proposals"], want["proposal_valid"] > 0, share=0.9)

    # FPS and KNN see only float32 points: their indices are the JAX
    # functions' on the same points, and the float32 forward's.
    assert len(calls["fps"]) == 3 and len(calls["knn"]) >= 4
    for pts, n, idx in calls["fps"]:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jax_fps(jnp.asarray(pts.numpy()), n)))
    for k, pts, qrs, idx in calls["knn"]:
        _, want_idx = _knn_reference_jnp(k, jnp.asarray(pts.numpy()), jnp.asarray(qrs.numpy()))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_rpn_bf16_indices_equal_float32_forward():
    """The bf16 and the float32 RPN on the same weights draw the same FPS
    samples and KNN neighbourhoods, call for call."""
    got, _, v, calls = _rpn_pair("test")
    f32 = RpnModel(torch_presets.rpn_unittest().model_config, 3, CLUSTER_SIZES)
    load_flax_variables(f32, v).eval()
    recorded = []
    knn = t_pointcnn.knn_point

    def rec_knn(k, pts, qrs):
        out = knn(k, pts, qrs)
        recorded.append(out[1])
        return out

    inp = {k: torch.from_numpy(x) for k, x in _inputs().items()}
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(t_pointcnn, "knn_point", rec_knn)
        want = f32(inp["point_cloud"], inp["image_input"], inp["stereo_calib_p2"])
    assert len(recorded) == len(calls["knn"])
    for a, (_, _, _, b) in zip(recorded, calls["knn"]):
        assert torch.equal(a, b)
    assert want["rpn_fts"].dtype == torch.float32
    _model_close(got["seg_logits"], want["seg_logits"], "bf16 vs float32 seg logits")


def _rcnn_cfg(presets, shared_map):
    cfg = presets.rcnn_unittest()
    cfg.model_config.compute_dtype = "bfloat16"
    cfg.model_config.rcnn_config.rcnn_use_rpn_img_feature_map = shared_map
    return cfg


@functools.lru_cache(maxsize=None)
def _rcnn_jax(shared_map):
    """The JAX RCNN in bf16 on the JAX bf16 RPN's outputs."""
    _, rpn_out, _, _ = _rpn_pair("test")
    model = JaxRcnn(config=_rcnn_cfg(jax_presets, shared_map).model_config, num_classes=3,
                    cluster_sizes=CLUSTER_SIZES, mode="test")
    inp = _inputs()
    prop = jnp.asarray(rpn_out["proposals"])
    bsz, n = prop.shape[:2]
    args = (
        prop, jnp.zeros((bsz, n)), jnp.zeros((bsz, n, 8)),
        jnp.asarray(rpn_out["rpn_pts"]), jnp.asarray(rpn_out["rpn_intensity"][..., 0]),
        jnp.asarray(rpn_out["foreground_mask"].astype(np.float32)),
        jnp.concatenate([jnp.asarray(rpn_out["rpn_fts"]), jnp.asarray(rpn_out["rpn_img_fts"])], -1),
        jnp.asarray(inp["image_input"]), jnp.asarray(inp["stereo_calib_p2"]),
    )
    v = random_variables(lambda: model.init(jax.random.PRNGKey(1), *args, training=False), 8)
    head = v["params"]["reg_output"]["Dense_0"]
    head["kernel"] = head["kernel"] * np.float32(0.1)
    head["bias"] = head["bias"] * np.float32(0.1)
    fmap = jnp.asarray(rpn_out["img_feature_map"]) if shared_map else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_pointcnn, "knn_point", _knn_reference_jnp)
        out = jax.jit(lambda v_, *a: model.apply(v_, *a, training=False, img_feature_map=fmap))(
            as_jax(v), *args)
    return v, jax.tree_util.tree_map(np.asarray, out)


def _torch_bf16(x) -> torch.Tensor:
    t = torch.from_numpy(np.array(_np(x)))
    return t.to(BF16) if np.asarray(x).dtype == jnp.bfloat16 else t


def test_rcnn_bf16_on_jax_stage1_matches_jax():
    """The RCNN alone on the JAX RPN's bf16 proposals and stage-1 tensors,
    its image map among them (the shared-VGG mode)."""
    _, rpn_out, _, _ = _rpn_pair("test")
    v, want = _rcnn_jax(True)
    cfg = _rcnn_cfg(torch_presets, True).model_config
    rcnn = RcnnModel(cfg, 3, CLUSTER_SIZES, 64 + 8)
    load_flax_variables(rcnn, v).eval()
    t = {k: _torch_bf16(x) for k, x in rpn_out.items()}
    inp = {k: torch.from_numpy(x) for k, x in _inputs().items()}
    with torch.no_grad():
        got = rcnn(t["proposals"], t["rpn_pts"], t["rpn_intensity"][..., 0],
                   t["foreground_mask"].float(), torch.cat([t["rpn_fts"], t["rpn_img_fts"]], -1),
                   inp["image_input"], inp["stereo_calib_p2"],
                   img_feature_map=t["img_feature_map"])
    assert got["cls_softmax"].dtype == torch.float32
    np.testing.assert_array_equal(got["non_empty_box_mask"].numpy(), want["non_empty_box_mask"])
    # Random BatchNorm statistics drive the class logits to ~35 here, where
    # one bf16 ulp is 0.25 and moves a softmax entry by up to ~0.06: the
    # logits are held, as log-softmax, within BF16_MODEL_TOL.
    _model_close(np.log(np.maximum(_np(got["cls_softmax"]), 1e-30)),
                 np.log(np.maximum(want["cls_softmax"], 1e-30)), "cls log-softmax")
    np.testing.assert_array_equal(got["num_boxes_before_padding"].numpy(),
                                  want["num_boxes_before_padding"])
    _matched_rows(got["final_boxes"], want["final_boxes"], want["final_valid"] > 0, share=0.9)


def test_two_stage_bf16_matches_jax():
    """The unittest-width detector end to end in bf16 (RPN -> RCNN on the
    RPN's image map), against the JAX RPN and RCNN on the same weights."""
    _, rpn_want, rpn_v, _ = _rpn_pair("test")
    rcnn_v, want = _rcnn_jax(True)
    rpn_cfg = torch_presets.rpn_unittest()
    rcnn_cfg = _rcnn_cfg(torch_presets, True)
    rpn_cfg.model_config.compute_dtype = "bfloat16"
    det = TwoStageDetector(rpn_cfg, rcnn_cfg)
    load_flax_variables(det.rpn, rpn_v)
    load_flax_variables(det.rcnn, rcnn_v)
    inp = {k: torch.from_numpy(x) for k, x in _inputs().items()}
    with torch.no_grad():
        got = det.eval()(inp["point_cloud"], inp["image_input"], inp["stereo_calib_p2"])
    for key in ("proposals", "proposal_scores", "final_boxes", "final_scores"):
        assert got[key].dtype == torch.float32, key
        assert torch.isfinite(got[key]).all(), key
    np.testing.assert_array_equal(got["num_final"].numpy(), want["num_boxes_before_padding"])
    _matched_rows(got["proposals"], rpn_want["proposals"], rpn_want["proposal_valid"] > 0,
                  share=0.9)
    # The final NMS keeps one box of each cluster by a score that random
    # weights saturate at 0.99-1.0, so bf16-level differences (and the ~10%
    # of proposals that stage 1 picked differently among near ties) change
    # which box a cluster keeps: the sorted scores are held within
    # BF16_MODEL_TOL and two thirds of the boxes matched.
    _model_close(got["final_scores"], want["final_scores"], "final_scores")
    _matched_rows(got["final_boxes"], want["final_boxes"], want["final_valid"] > 0,
                  share=2 / 3)


def test_bf16_parameters_stay_float32():
    """A bf16 model holds the float32 model's state dict, key for key and
    dtype for dtype, so a float32 checkpoint serves in bf16."""
    for presets_fn, build in (
        (torch_presets.rpn_unittest, lambda c: RpnModel(c, 3, CLUSTER_SIZES)),
        (torch_presets.rcnn_unittest, lambda c: RcnnModel(c, 3, CLUSTER_SIZES, 64 + 8)),
    ):
        f32 = build(presets_fn().model_config).state_dict()
        cfg = presets_fn().model_config
        cfg.compute_dtype = "bfloat16"
        bf = build(cfg)
        sd = bf.state_dict()
        assert list(sd) == list(f32)
        assert all(sd[k].dtype == f32[k].dtype for k in sd)
        assert all(p.dtype == torch.float32 for p in bf.parameters())
        bf.load_state_dict(f32)
