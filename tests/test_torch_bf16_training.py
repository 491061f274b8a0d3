"""bf16 training (`compute_dtype` "bfloat16" in train mode) of the port
against the JAX package, on the CPU at `rpn_unittest` / `rcnn_unittest`
widths. Mixed precision as flax has it: parameters, gradients, Adam
moments, the EMA, BatchNorm statistics and checkpoints float32; the layers
compute in bf16; the heads are cast to float32 before the losses.

Flax variables are drawn at random from a seed and carried into the port
by `heterofusionrcnn_torch.convert`; both sides get the same numpy inputs
(the port loader's batches of the fixture frames, real labels). The JAX
PointCNN takes the direct-distance KNN (tests/test_torch_layers.py).

Modules against eager flax (`jax.disable_jit()`, where flax rounds to bf16
after every op as the port does):

- BatchNorm and BatchNorm2d in training, with a channel of large mean (the
  fast variance's cancellation, kept on both sides): the output and the
  input's gradient within one bf16 ulp (measured: bit-equal), the running
  statistics within 1e-6 relative, the scale and bias gradients (float32
  sums) within 1e-6 of their largest element.
- The XConv (train mode, its layers one by one) with and without the
  X-transform, and the VGG pyramid: outputs within one ulp plus
  MODULE_ATOL_SHARE of the largest magnitude (a float32 sum in another
  order rounds one intermediate element to the neighbouring bf16 value,
  and the X-mix and the BatchNorms carry it on: measured 9.5e-4 with the
  X-transform, bit-equal without it and in the VGG), the new BatchNorm
  statistics within 1e-4 relative, every parameter's gradient of a float32
  scalar of the output within MODULE_GRAD_SHARE of the tensor's largest
  element (measured 1.1e-2 in the VGG, 1.1e-2 and 3.1e-5 in the XConv).
  The biases that a training BatchNorm follows (BN_FOLLOWED_BIAS) have a
  gradient of 0 in exact arithmetic, rounding noise on each side: they are
  named and left out.

Models against the jitted JAX train step. XLA's fusions drop some of
flax's bf16 roundings, and bf16 gradients resolve coarsely: JAX's own two
evaluations of one RPN gradient (eager and jitted) differ by up to 0.30
(image branch) and 0.083 (elsewhere) of a tensor's largest element, and
by 0.28 / 0.061 in relative L2 norm (`python -m
tests.test_torch_bf16_training` prints these measurements). So:

- losses within LOSS_RTOL; the heads (segmentation softmax, bin scores and
  residuals at the GT class) within HEAD_TOL; masks, one-hot targets and
  regression targets as in float32 (exact, and 1e-5);
- each gradient tensor within GRAD_SHARE of its largest element and
  GRAD_L2 in relative L2 norm, both wider in the image branch (measured,
  elsewhere / image branch: the RPN 0.071 / 0.29 share and 0.053 / 0.31
  L2, the RCNN 0.061 / 0.37 and 0.052 / 0.43, the two steps below 0.081 /
  0.49 and 0.092 / 0.36); the biases that a training BatchNorm follows
  left out (18 tensors in the RPN, 13 in the RCNN);
- after two `make_rpn_train_step` steps (the second from the JAX state
  after the first on both sides, EMA on), the step's gradients (from
  Adam's first moment) as above; every parameter and EMA entry within
  rtol 1e-3 / atol 1e-5 plus 2 x lr |dg| / sqrt(v_hat) (Adam's update
  moves by about lr |dg| / sqrt(v_hat) for a gradient moved by dg), at
  most 2 x lr; the elements held at that cap (their two gradients differ
  by more than the gradient itself: bf16 does not resolve their update's
  sign) are counted and bounded near the measured count (WIDENED_MAX:
  7,456 and 2,607 of 158,312 elements, bounded at about 1.2 times);
  the BatchNorm statistics within STATS_SHARE of the tensor's largest
  element.

Training runs: three bf16 steps on a re-fed batch lower the loss (the port's
mirror of the JAX test_rpn_train_step_decreases_loss_bf16, and an RCNN
twin), with every parameter, moment and EMA entry float32; the training
CLI with a bf16 pipeline config trains, checkpoints float32 tensors only
and resumes, and its checkpoint loads into a float32 model and back; the
whole two-stage workflow (RPN training, its train and val handoffs, RCNN
training and the RCNN's evaluation) runs from bf16 configs through the
CLIs.
"""

from __future__ import annotations

import copy
import functools
import glob
import os
import tempfile

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from heterofusionrcnn_tpu.models import rcnn as j_rcnn
from heterofusionrcnn_tpu.models import rpn as j_rpn
from heterofusionrcnn_tpu.models.extractors import img_vgg_pyr as j_vgg
from heterofusionrcnn_tpu.models.extractors import pointcnn as j_pointcnn
from heterofusionrcnn_tpu.runtime.optimizer import build_optimizer as j_build_optimizer
from heterofusionrcnn_tpu.runtime.train_state import TrainState as JaxTrainState
from heterofusionrcnn_tpu.runtime.train_state import make_rpn_train_step as j_make_step

from heterofusionrcnn_torch.configs import presets as torch_presets
from heterofusionrcnn_torch.configs.config import save_config
from heterofusionrcnn_torch.convert import flax_to_state_dict, load_flax_variables
from heterofusionrcnn_torch.datasets.kitti.dataset import KittiDataset
from heterofusionrcnn_torch.experiments import common, run_evaluation, run_training
from heterofusionrcnn_torch.inference import CLUSTER_SIZES
from heterofusionrcnn_torch.models import rpn as t_rpn
from heterofusionrcnn_torch.models.extractors import img_vgg_pyr as t_vgg
from heterofusionrcnn_torch.models.extractors import layers as t_layers
from heterofusionrcnn_torch.models.extractors import pointcnn as t_pointcnn
from heterofusionrcnn_torch.models.extractors.layers import init_weights
from heterofusionrcnn_torch.models.rcnn import rcnn_loss
from heterofusionrcnn_torch.models.rpn import RpnModel, rpn_loss
from heterofusionrcnn_torch.ops.grouping import knn_point
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
from heterofusionrcnn_torch.runtime.optimizer import ADAM_B1, ADAM_B2, ADAM_EPS, build_optimizer
from heterofusionrcnn_torch.runtime.train_state import (
    RPN_BATCH_KEYS,
    TrainState,
    make_rpn_train_step,
    train_step,
)

from tests import test_torch_rcnn_training as rcnn_tests
from tests.test_torch_rcnn_training import _jax_snapshot
from tests.rcnn_fixtures import write_handoff
from tests.test_torch_layers import as_jax, direct_knn, random_variables
from tests.test_torch_training import (
    BN_FOLLOWED_BIAS,
    _batches,
    _configs,
    _jax_rpn,
)

BF16 = torch.bfloat16
ULP = 2.0 ** -7
MODULE_ATOL_SHARE = 2.0 ** -9
MODULE_GRAD_SHARE = 2e-2
LOSS_RTOL = 2.0 ** -7
HEAD_TOL = dict(rtol=2.0 ** -6, scale_share=0.04)
# Per part: (the image branch, everything else).
GRAD_SHARE = (0.6, 0.15)
GRAD_L2 = (0.5, 0.12)
STATS_SHARE = 1e-2
# Per step of `test_rpn_bf16_two_train_steps_match_jax`: the most elements
# whose update bf16 does not resolve (measured 7,456 and 2,607).
WIDENED_MAX = (9_000, 3_200)
IMAGE_BRANCH = "img_vgg_pyr."


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the tier-1 run has several workers a core
    set, and torch's spinning thread pools would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    """A torch tensor or JAX array as float32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.detach().float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _within_ulps(got, want, atol_share=0.0):
    """|got - want| <= one bf16 ulp of |want| + atol_share x max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    atol = atol_share * float(np.abs(want).max())
    np.testing.assert_array_less(np.abs(got - want), ULP * np.abs(want) + atol + 1e-30)


def _share(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def _l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(float(np.linalg.norm(want)), 1e-30))


def _heads_close(got, want, name):
    got, want = _np(got), _np(want)
    bound = HEAD_TOL["rtol"] * np.abs(want) + HEAD_TOL["scale_share"] * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), (name, _share(got, want))


def _bn_followed(name) -> bool:
    """A bias that a training BatchNorm follows (a module's own parameter
    names included)."""
    return bool(BN_FOLLOWED_BIAS.search("." + name))


def _part(name) -> int:
    return 0 if name.startswith(IMAGE_BRANCH) else 1


def _model_grads_close(got, want, n_bn_followed):
    """Gradients {name: tensor} against JAX's at model level (module
    docstring); returns the worst (share, L2) per part."""
    assert sorted(got) == sorted(want)
    assert sum(bool(_bn_followed(n)) for n in got) == n_bn_followed
    worst = [[0.0, 0.0], [0.0, 0.0]]
    for name, g in got.items():
        if _bn_followed(name):
            continue
        part = _part(name)
        share, l2 = _share(g, want[name]), _l2(g, want[name])
        assert share <= GRAD_SHARE[part] and l2 <= GRAD_L2[part], (name, share, l2)
        worst[part] = [max(worst[part][0], share), max(worst[part][1], l2)]
    return worst


def _module_grads_close(module, grads):
    want = flax_to_state_dict(grads)
    worst = 0.0
    for name, p in module.named_parameters():
        if _bn_followed(name):
            continue
        share = _share(p.grad, want[name])
        assert share <= MODULE_GRAD_SHARE, (name, share)
        worst = max(worst, share)
    return worst


def _stats_close(module, batch_stats, rtol):
    want = flax_to_state_dict({}, batch_stats)
    sd = module.state_dict()
    assert want
    for name, val in want.items():
        assert sd[name].dtype == torch.float32
        np.testing.assert_allclose(sd[name].numpy(), val.numpy(), rtol=rtol, atol=1e-30,
                                   err_msg=name)


def _bf16_configs(configs):
    for cfg in configs:
        cfg.model_config.compute_dtype = "bfloat16"
    return configs


# --------------------------------------------------------------- layers --


@pytest.mark.parametrize("layout", ["last", "nchw"])
def test_batch_norm_bf16_training_matches_flax(layout):
    """`BatchNorm` / `BatchNorm2d` in training on a bf16 input against
    `flax.linen.BatchNorm(dtype=bfloat16)`: float32 statistics (one channel
    of mean 40, where E[x^2] - E[x]^2 cancels), float32 normalisation, one
    rounding to bf16."""
    rng = np.random.default_rng(0)
    shape, axis = ((4, 16, 6), -1) if layout == "last" else ((2, 5, 6, 7), 1)
    c = shape[axis]
    x = rng.standard_normal(shape).astype(np.float32) * 3
    x[(slice(None),) * (axis % len(shape)) + (0,)] += 40.0
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    cot = rng.standard_normal(shape).astype(np.float32)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)},
         "batch_stats": {"mean": (rng.standard_normal(c) * 0.1).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3,
                        dtype=jnp.bfloat16, axis=axis)

    def f(params, xx):
        y, upd = mod.apply({"params": params, "batch_stats": as_jax(v["batch_stats"])}, xx,
                           mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, upd["batch_stats"])

    with jax.disable_jit():
        (_, (want, stats)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            as_jax(v["params"]), xb)
    bn = (t_layers.BatchNorm if layout == "last" else t_layers.BatchNorm2d)(c)
    load_flax_variables(bn, v).train()
    xt = torch.from_numpy(_np(xb)).to(BF16).requires_grad_(True)
    got = bn(xt)
    (got.float() * torch.from_numpy(cot)).sum().backward()
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert xt.grad.dtype == BF16 and bn.weight.grad.dtype == torch.float32
    _within_ulps(got, want)
    _within_ulps(xt.grad, gx)
    _stats_close(bn, stats, 1e-6)
    for name, g in (("weight", gp["scale"]), ("bias", gp["bias"])):
        assert _share(getattr(bn, name).grad, g) <= 1e-6, name


def test_dropout_and_path_drop_keep_bf16():
    """Dropout of a bf16 input is bf16 (`inputs / keep_prob` of a Python
    float, as flax's); the path-drop masks (float32 0-d tensors) keep bf16
    features bf16, as JAX's weakly typed masks do, with the same values."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).to(BF16)
    y = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).to(BF16)
    out = t_layers.dropout(x, 0.3, torch.Generator().manual_seed(0))
    assert out.dtype == BF16
    kept = out != 0
    assert bool(kept.any()) and not bool(kept.all())
    np.testing.assert_array_equal(_np(out[kept]),
                                  _np(jnp.asarray(_np(x)).astype(jnp.bfloat16)[kept.numpy()]
                                      / 0.7))
    xj, yj = (jnp.asarray(_np(t)).astype(jnp.bfloat16) for t in (x, y))
    for u in ([0.95, 0.5, 0.7], [0.5, 0.95, 0.3], [0.95, 0.95, 0.7], [0.95, 0.95, 0.3],
              [0.5, 0.5, 0.5]):
        img, pc = t_rpn.create_path_drop_masks(0.9, 0.9, torch.tensor(u))
        jimg, jpc = j_rpn.create_path_drop_masks(0.9, 0.9, jnp.asarray(u, jnp.float32))
        for got, want in ((x * pc, xj * jpc), (y * img, yj * jimg),
                          ((x * pc + y * img) / (img + pc), (xj * jpc + yj * jimg) / (jimg + jpc))):
            assert got.dtype == BF16 and want.dtype == jnp.bfloat16
            np.testing.assert_array_equal(_np(got), _np(want))


# -------------------------------------------------------------- modules --


@pytest.mark.parametrize("with_x", [True, False], ids=["x", "no_x"])
def test_xconv_bf16_training_matches_eager_flax(with_x):
    """One bf16 XConv in training (its layers one by one, the global branch
    and 12 input features with the X-transform, 5 without) against eager
    flax: output, new BatchNorm statistics, every parameter's gradient;
    the output and every gradient bf16 / float32 as flax's."""
    with_global, cp = (True, 12) if with_x else (False, 5)
    rng = np.random.default_rng(3)
    b, n, p, k = 2, 96, 32, 8
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    fts = rng.standard_normal((b, n, cp)).astype(np.float32)
    qrs = pts[:, :p]
    _, idx = knn_point(k, torch.from_numpy(pts), torch.from_numpy(qrs))
    mod = j_pointcnn.XConv(K=k, D=1, C=32, C_pts_fts=16, depth_multiplier=2,
                           with_X_transformation=with_x, with_global=with_global,
                           dtype=jnp.bfloat16)
    args = (jnp.asarray(pts), jnp.asarray(fts), jnp.asarray(qrs))
    jidx = jnp.asarray(idx.numpy())
    v = random_variables(lambda: mod.init(jax.random.PRNGKey(0), *args, False, nn_idx=jidx), 4)
    cot = rng.standard_normal((b, p, 32 + (8 if with_global else 0))).astype(np.float32)

    def f(params):
        out, upd = mod.apply({"params": params, "batch_stats": v["batch_stats"]}, *args, True,
                             nn_idx=jidx, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * cot), (out, upd["batch_stats"])

    with jax.disable_jit():
        (_, (want, stats)), grads = jax.value_and_grad(f, has_aux=True)(as_jax(v["params"]))
    ours = t_pointcnn.XConv(k, 1, 32, 16, cp, 2, with_X_transformation=with_x,
                            with_global=with_global, dtype=BF16)
    load_flax_variables(ours, v).train()
    got = ours(torch.from_numpy(pts), torch.from_numpy(fts), torch.from_numpy(qrs), idx)
    (got.float() * torch.from_numpy(cot)).sum().backward()
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert all(p_.grad.dtype == torch.float32 for p_ in ours.parameters())
    _within_ulps(got, want, MODULE_ATOL_SHARE)
    _stats_close(ours, stats, 1e-4)
    _module_grads_close(ours, grads)


def test_img_vgg_pyr_bf16_training_matches_eager_flax():
    """The bf16 VGG pyramid in training (cuDNN-style unfused convs, batch
    statistics) against eager flax: output, statistics, gradients."""
    rng = np.random.default_rng(1)
    cfg = torch_presets.rpn_unittest().model_config.layers_config.img_vgg_pyr
    jcfg = _configs()[0].model_config.layers_config.img_vgg_pyr
    img = rng.uniform(0, 255, (1, 24, 40, 3)).astype(np.float32)
    mod = j_vgg.ImgVggPyr(jcfg, dtype=jnp.bfloat16)
    x = j_vgg.preprocess_image(jnp.asarray(img))
    v = random_variables(lambda: mod.init(jax.random.PRNGKey(0), x, False), 2)
    cot = rng.standard_normal((1, 24, 40, cfg.vgg_conv1[1])).astype(np.float32)

    def f(params):
        out, upd = mod.apply({"params": params, "batch_stats": v["batch_stats"]}, x, True,
                             mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * cot), (out, upd["batch_stats"])

    with jax.disable_jit():
        (_, (want, stats)), grads = jax.value_and_grad(f, has_aux=True)(as_jax(v["params"]))
    ours = load_flax_variables(t_vgg.ImgVggPyr(cfg, dtype=BF16), v).train()
    got = ours(t_vgg.preprocess_image(torch.from_numpy(img)))
    (got.float() * torch.from_numpy(cot)).sum().backward()
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_ulps(got, want, MODULE_ATOL_SHARE)
    _stats_close(ours, stats, 1e-4)
    _module_grads_close(ours, grads)


# --------------------------------------------------------------- models --


def _rpn_forward_pair():
    """The bf16 RPN in train mode on both sides (dropout 0, path drop off;
    path drop's bf16 masks: `test_dropout_and_path_drop_keep_bf16`): JAX's
    jitted losses, predictions, statistics and gradients, and the port's."""
    jcfg, tcfg = _bf16_configs(_configs())
    batch = _batches()[0]
    model, args = _jax_rpn("train", jcfg, batch)
    v = random_variables(lambda: model.init(jax.random.PRNGKey(0), *args, training=False), 11)

    def f(params):
        preds, upd = model.apply({"params": params, "batch_stats": v["batch_stats"]}, *args,
                                 training=True, mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(1),
                                       "path_drop": jax.random.PRNGKey(2)})
        loss_dict, total = j_rpn.rpn_loss(preds, jcfg.model_config)
        return total, (loss_dict, preds, upd)

    (total, (loss_dict, want, upd)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        as_jax(v["params"]))
    ours = RpnModel(tcfg.model_config, 3, CLUSTER_SIZES, mode="train")
    load_flax_variables(ours, v).train()
    got = ours(*(torch.from_numpy(batch[k]) for k in RPN_BATCH_KEYS))
    got_losses, got_total = rpn_loss(got, tcfg.model_config)
    got_total.backward()
    return dict(want=want, loss_dict=loss_dict, total=total, stats=upd["batch_stats"],
                grads=flax_to_state_dict(grads), got=got, got_losses=got_losses,
                got_total=got_total, model=ours)


def test_rpn_bf16_train_forward_and_gradients_match_jax(monkeypatch):
    """The bf16 RPN in train mode against JAX's jitted one: the float32
    heads and losses, the targets, the new BatchNorm statistics and every
    parameter's (float32) gradient, at bf16 resolution."""
    direct_knn(monkeypatch)
    r = _rpn_forward_pair()
    got, want = r["got"], r["want"]
    for key in ("seg_softmax", "seg_accuracy"):
        assert got[key].dtype == torch.float32
    assert abs(float(r["got_total"].detach()) - float(r["total"])) <= LOSS_RTOL * abs(
        float(r["total"]))
    for key, val in r["loss_dict"].items():
        assert abs(float(r["got_losses"][key].detach()) - float(val)) <= LOSS_RTOL * abs(
            float(val)), key
    _heads_close(got["seg_softmax"], want["seg_softmax"], "seg_softmax")
    for key in ("cls_preds", "reg_preds"):
        for g, w in zip(got[key], want[key]):
            assert g.dtype == torch.float32
            _heads_close(g, w, key)
    for g, w in zip(got["reg_gts"], want["reg_gts"]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)
    for g, w in zip(got["cls_gts"], want["cls_gts"]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_array_equal(_np(got["foreground_mask"]), np.asarray(want["foreground_mask"]))
    want_stats = flax_to_state_dict({}, r["stats"])
    sd = r["model"].state_dict()
    for name, val in want_stats.items():
        assert sd[name].dtype == torch.float32
        assert _share(sd[name], val) <= STATS_SHARE, name
    grads = {n: p.grad for n, p in r["model"].named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    _model_grads_close(grads, r["grads"], 18)


@pytest.fixture(scope="module")
def handoff(tmp_path_factory):
    cfg = torch_presets.rcnn_unittest()
    return write_handoff(KittiDataset(cfg.dataset_config, "train"),
                         str(tmp_path_factory.mktemp("handoff")))


def _rcnn_forward_pair(handoff):
    jcfg, tcfg = _bf16_configs(rcnn_tests._configs())
    batch = rcnn_tests._batches(*handoff)[0]
    model = rcnn_tests._jax_rcnn("train", jcfg)
    args = [jnp.asarray(batch[k]) for k in common.RCNN_BATCH_KEYS]
    v = random_variables(lambda: model.init(jax.random.PRNGKey(0), *args, training=False), 21)
    rngs = {"dropout": jax.random.PRNGKey(1), "path_drop": jax.random.PRNGKey(2)}

    def f(params):
        preds, upd = model.apply({"params": params, "batch_stats": v["batch_stats"]}, *args,
                                 training=True, mutable=["batch_stats"], rngs=rngs)
        loss_dict, total = j_rcnn.rcnn_loss(preds, jcfg.model_config)
        return total, (loss_dict, preds, upd)

    (total, (loss_dict, want, upd)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        as_jax(v["params"]))
    ours = rcnn_tests._ours("train", tcfg)
    load_flax_variables(ours, v).train()
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    got = common.rcnn_forward(ours, tb)
    got_losses, got_total = rcnn_loss(got, tcfg.model_config)
    got_total.backward()
    return dict(want=want, loss_dict=loss_dict, total=total, stats=upd["batch_stats"],
                grads=flax_to_state_dict(grads), got=got, got_losses=got_losses,
                got_total=got_total, model=ours, rpn_fts=tb["rpn_fts"])


def test_rcnn_bf16_train_forward_and_gradients_match_jax(monkeypatch, handoff):
    """The bf16 RCNN in train mode on a synthetic handoff (positive RoIs)
    against JAX's jitted one: losses, float32 heads, targets and masks,
    statistics and gradients at bf16 resolution; the handoff's float32
    features stay float32 and get no gradient."""
    direct_knn(monkeypatch)
    r = _rcnn_forward_pair(handoff)
    got, want = r["got"], r["want"]
    assert r["rpn_fts"].dtype == torch.float32 and r["rpn_fts"].grad is None
    assert float(r["got_losses"]["rcnn_reg_loss"].detach()) > 0
    assert abs(float(r["got_total"].detach()) - float(r["total"])) <= LOSS_RTOL * abs(
        float(r["total"]))
    for key, val in r["loss_dict"].items():
        assert abs(float(r["got_losses"][key].detach()) - float(val)) <= LOSS_RTOL * abs(
            float(val)), key
    assert got["cls_logits"].dtype == got["cls_softmax"].dtype == torch.float32
    _heads_close(got["cls_logits"], want["cls_logits"], "cls_logits")
    for key in ("mb_cls_preds", "mb_reg_preds"):
        for g, w in zip(got[key], want[key]):
            assert g.dtype == torch.float32
            _heads_close(g, w, key)
    for g, w in zip(got["mb_reg_gts"], want["mb_reg_gts"]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)
    for key in ("non_empty_box_mask", "pos_neg_cls_mask", "pos_reg_mask", "cls_gt_one_hot"):
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]), err_msg=key)
    want_stats = flax_to_state_dict({}, r["stats"])
    sd = r["model"].state_dict()
    for name, val in want_stats.items():
        assert _share(sd[name], val) <= STATS_SHARE, name
    _model_grads_close({n: p.grad for n, p in r["model"].named_parameters()}, r["grads"], 13)


# ----------------------------------------------------------- train steps --


@functools.lru_cache(maxsize=1)
def _rpn_two_steps():
    """Two bf16 RPN train steps on both sides (dropout 0, path drop off,
    EMA on): JAX runs both; the port runs the first from the same
    variables and the second from the JAX state after the first. Per step:
    both metrics, both step gradients (from Adam's first moment), the JAX
    state and the port's after it, and JAX's second moment."""
    jcfg, tcfg = _bf16_configs(_configs())
    for cfg in (jcfg, tcfg):
        cfg.train_config.optimizer.use_moving_average = True
        cfg.train_config.optimizer.moving_average_decay = 0.9
    batches = _batches()
    model, args = _jax_rpn("train", jcfg, batches[0])
    v = random_variables(lambda: model.init(jax.random.PRNGKey(0), *args, training=False), 13)
    tx = j_build_optimizer(jcfg.train_config.optimizer, 1, jcfg.train_config.grad_clip_norm)
    jstate = JaxTrainState.create(model.apply, as_jax(v["params"]), as_jax(v["batch_stats"]), tx)
    jstep = j_make_step(lambda p: j_rpn.rpn_loss(p, jcfg.model_config))

    ours = load_flax_variables(RpnModel(tcfg.model_config, 3, CLUSTER_SIZES, mode="train"), v)
    opt = build_optimizer(ours, tcfg.train_config.optimizer, 1, tcfg.train_config.grad_clip_norm)
    state = TrainState.create(ours, opt, seed=0)
    step = make_rpn_train_step(lambda p: rpn_loss(p, tcfg.model_config))
    rng = jax.random.PRNGKey(100)
    steps = []
    mu_before = {n: torch.zeros_like(p) for n, p in ours.named_parameters()}
    for i, b in enumerate(batches):
        if i:  # the port continues from the JAX state
            module_sd, opt_sd = steps[-1]["jax"]
            ours.load_state_dict(module_sd, strict=False)
            opt.load_state_dict(opt_sd)
            mu_before = opt_sd["state"]["mu"]
        jstate, jm, rng = jstep(jstate, {k: jnp.asarray(b[k]) for k in RPN_BATCH_KEYS}, rng)
        tm = step(state, {k: torch.from_numpy(b[k]) for k in RPN_BATCH_KEYS})
        snap = _jax_snapshot(jstate)
        tmu = opt.state_dict()["state"]["mu"]
        steps.append(dict(
            jax=snap, port=(copy.deepcopy(ours.state_dict()), copy.deepcopy(opt.state_dict())),
            jax_metrics=jax.tree_util.tree_map(np.asarray, jm), port_metrics=tm,
            jax_grads={n: (m - ADAM_B1 * mu_before[n]) / (1 - ADAM_B1)
                       for n, m in snap[1]["state"]["mu"].items()},
            port_grads={n: (m - ADAM_B1 * mu_before[n]) / (1 - ADAM_B1) for n, m in tmu.items()}))
    return steps, state, float(opt.schedule(0))


def _update_noise(dg, nu, count, lr):
    """2 x lr |dg| / sqrt(v_hat), capped at 2 x lr (module docstring)."""
    v_hat = nu / (1 - ADAM_B2 ** count)
    return torch.clamp(2 * lr * dg / (torch.sqrt(v_hat) + ADAM_EPS), max=2 * lr)


def test_rpn_bf16_two_train_steps_match_jax(monkeypatch):
    """Two bf16 `make_rpn_train_step` steps against the JAX package's: per
    step the metrics, the step's gradients, then every parameter, EMA entry
    and BatchNorm statistic, all float32, with the widening and the count
    of the module docstring."""
    direct_knn(monkeypatch)
    steps, state, lr = _rpn_two_steps()
    for i, st in enumerate(steps):
        jm, tm = st["jax_metrics"], st["port_metrics"]
        assert sorted(jm) == sorted(tm)
        for key in jm:
            assert abs(float(tm[key]) - float(jm[key])) <= LOSS_RTOL * abs(float(jm[key])), key
        _model_grads_close(st["port_grads"], st["jax_grads"], 18)
        (want, want_opt), (got, got_opt) = st["jax"], st["port"]
        assert got_opt["count"] == want_opt["count"] == i + 1
        noise, widened = {}, 0
        for n, jg in st["jax_grads"].items():
            if _bn_followed(n):  # 0 in exact arithmetic: noise on each side
                noise[n] = torch.full_like(jg, 2 * lr)
                continue
            noise[n] = _update_noise((st["port_grads"][n] - jg).abs(),
                                     want_opt["state"]["nu"][n], i + 1, lr)
            widened += int((noise[n] >= 2 * lr).sum())
        assert widened <= WIDENED_MAX[i], (i, widened)
        pairs = [(n, got[n], val) for n, val in want.items() if n in noise]
        pairs += [(n, got_opt["ema"][n], val) for n, val in want_opt["ema"].items()]
        for name, g, w in pairs:
            assert g.dtype == torch.float32, name
            bound = 1e-5 + 1e-3 * w.abs() + noise[name]
            assert bool(((g - w).abs() <= bound).all()), (i, name, float((g - w).abs().max()))
        for name, w in want.items():
            if name not in noise:  # a BatchNorm statistic
                assert got[name].dtype == torch.float32
                assert _share(got[name], w) <= STATS_SHARE, (i, name)
    assert state.step == 2


# ------------------------------------------------------- training runs --


def _three_steps_lower_the_loss(model, loss_fn, cfg, batch, forward):
    init_weights(model, 0)
    opt = build_optimizer(model, cfg.train_config.optimizer, 1, cfg.train_config.grad_clip_norm)
    state = TrainState.create(model, opt, seed=0)

    def step(st, b):
        return train_step(st, lambda m, gens: forward(m, b, gens), loss_fn)[1]

    losses = [float(step(state, batch)["total_loss"]) for _ in range(3)]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert state.step == 3
    tensors = [*model.parameters(), *model.buffers(), *opt.ema,
               *(t for moment in opt.state.values() for t in moment)]
    assert all(t.dtype == torch.float32 for t in tensors if t.is_floating_point())
    return losses


def test_rpn_bf16_train_steps_lower_the_loss():
    """The port's mirror of the JAX test_rpn_train_step_decreases_loss_bf16:
    `rpn_unittest` in bf16 (dropout and path drop as configured, EMA on),
    three steps on one re-fed batch of one frame lower the loss."""
    cfg = torch_presets.rpn_unittest()
    cfg.model_config.compute_dtype = "bfloat16"
    cfg.train_config.optimizer.use_moving_average = True
    ds = KittiDataset(cfg.dataset_config, "train")
    ds.seed(0)
    batch = {k: torch.from_numpy(v) for k, v in common.make_batch_fn(cfg, ds, "rpn", 1)().items()}
    model, loss_fn = common.build_model(cfg, ds, "train")
    assert model.dtype == BF16
    _three_steps_lower_the_loss(
        model, loss_fn, cfg, batch,
        lambda m, b, gens: m(*(b[k] for k in RPN_BATCH_KEYS), generators=gens))


def test_rcnn_bf16_train_steps_lower_the_loss(handoff):
    """The RCNN twin: `rcnn_unittest` in bf16 on the synthetic handoff,
    three steps on one re-fed batch (a positive RoI) lower the loss."""
    cfg = torch_presets.rcnn_unittest()
    cfg.model_config.compute_dtype = "bfloat16"
    cfg.train_config.optimizer.use_moving_average = True
    ds = KittiDataset(cfg.dataset_config, "train")
    ds.seed(0)
    ds.proposal_dir, ds.proposal_iou_dir, ds.rpn_feature_dir = handoff
    batch = {k: torch.from_numpy(v) for k, v in common.make_batch_fn(cfg, ds, "rcnn", 2)().items()}
    assert bool((batch["rpn_iou"] > 0.55).any())
    model, loss_fn = common.build_model(cfg, ds, "train")
    assert model.dtype == BF16
    _three_steps_lower_the_loss(model, loss_fn, cfg, batch, common.rcnn_forward)


def test_run_training_bf16_cli(tmp_path, capsys):
    """`run_training --device cpu` with a bf16 pipeline config: 3 steps
    (checkpoints 2 and 3), a resume to 4; every checkpoint tensor float32;
    the bf16 run's module weights load into a float32 RPN, and a float32
    checkpoint into a bf16 one."""
    cfg = torch_presets.rpn_unittest()
    cfg.model_config.compute_dtype = "bfloat16"
    cfg.model_config.checkpoint_name = "rpn_bf16"
    path = tmp_path / "rpn_bf16.json"
    save_config(cfg, str(path))
    argv = ["--device", "cpu", "--pipeline_config", str(path), "--output_root", str(tmp_path)]
    state = run_training.main(argv)
    assert state.step == 3 and state.model.dtype == BF16
    resumed = run_training.main(argv + ["--max_iterations", "4"])
    assert "Resumed from step 3" in capsys.readouterr().out
    assert resumed.step == 4
    ckpt = CheckpointManager(str(tmp_path / "rpn_bf16" / "checkpoints"))
    assert ckpt.all_steps() == [2, 3, 4]

    def floats(tree):
        if isinstance(tree, torch.Tensor):
            return [tree] if tree.is_floating_point() else []
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in floats(v)]
        if isinstance(tree, (list, tuple)):
            return [t for v in tree for t in floats(v)]
        return []

    raw = ckpt.restore_raw()
    assert floats(raw) and all(t.dtype == torch.float32 for t in floats(raw))
    f32 = RpnModel(torch_presets.rpn_unittest().model_config, 3, CLUSTER_SIZES, mode="train")
    f32.load_state_dict(raw["state_dict"])
    bf = RpnModel(cfg.model_config, 3, CLUSTER_SIZES, mode="train")
    bf.load_state_dict(f32.state_dict())
    assert all(torch.equal(a, b) for a, b in zip(bf.state_dict().values(),
                                                 raw["state_dict"].values()))


def test_two_stage_workflow_bf16_clis(tmp_path):
    """The whole two-stage workflow from bf16 pipeline configs through the
    CLIs on the CPU: RPN training, its evaluation writing the train and val
    handoffs, RCNN training from the train handoff (warm-started from the
    RPN) and the RCNN's evaluation over the val handoff; float32
    checkpoints, finite handoff features and final rows."""
    root = str(tmp_path)
    base = ["--device", "cpu", "--output_root", root]
    paths = {}
    for preset, name in ((torch_presets.rpn_unittest, "rpn_bf16"),
                         (torch_presets.rcnn_unittest, "rcnn_bf16")):
        cfg = preset()
        cfg.model_config.compute_dtype = "bfloat16"
        cfg.model_config.checkpoint_name = name
        paths[name] = str(tmp_path / f"{name}.json")
        save_config(cfg, paths[name])
    run_training.main(base + ["--pipeline_config", paths["rpn_bf16"], "--max_iterations", "1"])
    for split, extra in (("train", ["--for_rcnn_train"]), ("val", [])):
        summary, = run_evaluation.main(base + ["--pipeline_config", paths["rpn_bf16"],
                                               "--data_split", split, "--save_rpn_feature",
                                               *extra])
        assert summary["global_step"] == 1

    def flags(split):
        pred = os.path.join(root, "rpn_bf16", "predictions")
        dirs = [os.path.join(pred, d, split, "1")
                for d in ("proposals_and_scores", "proposals_iou", "rpn_feature")]
        for f in glob.glob(os.path.join(dirs[2], "*.npy")):
            arr = np.load(f)
            assert arr.dtype == np.float32 and np.isfinite(arr).all()
        return ["--proposal_dir", dirs[0], "--proposal_iou_dir", dirs[1],
                "--rpn_feature_dir", dirs[2]]

    state = run_training.main(base + ["--pipeline_config", paths["rcnn_bf16"], "--max_iterations",
                                      "2", "--warm_start_from",
                                      os.path.join(root, "rpn_bf16", "checkpoints")]
                              + flags("train"))
    assert state.step == 2 and state.model.dtype == BF16
    for name in ("rpn_bf16", "rcnn_bf16"):
        raw = CheckpointManager(os.path.join(root, name, "checkpoints")).restore_raw()
        assert all(t.dtype == torch.float32 for t in raw["state_dict"].values()
                   if t.is_floating_point()), name
    summary, = run_evaluation.main(base + ["--pipeline_config", paths["rcnn_bf16"],
                                           "--data_split", "val", "--num_rois", "16"]
                                   + flags("val"))
    assert np.isfinite(summary["avg_losses"]["rcnn_total_loss"])
    finals = glob.glob(os.path.join(root, "rcnn_bf16", "predictions",
                                    "final_predictions_and_scores", "val", "2", "*.txt"))
    assert len(finals) == 6
    assert all(np.isfinite(np.loadtxt(f, ndmin=2)).all() for f in finals)


# ---------------------------------------------------------------- report --


def precision_report():
    """The measurements behind the tolerances: the port's model-level
    gradients against JAX's jitted ones and JAX's eager against its jitted
    ones (the RPN, ~3 min for the eager run), per part the worst share of
    the largest element and relative L2; the RCNN's; the widened counts of
    the two steps."""
    from heterofusionrcnn_tpu.ops.pallas_knn import _knn_reference_jnp

    j_pointcnn.knn_point = _knn_reference_jnp
    r = _rpn_forward_pair()
    port = {n: p.grad for n, p in r["model"].named_parameters()}

    def worst(got, want):
        out = [[0.0, 0.0], [0.0, 0.0]]
        for n, g in got.items():
            if not _bn_followed(n):
                p = _part(n)
                out[p] = [max(out[p][0], _share(g, want[n])), max(out[p][1], _l2(g, want[n]))]
        return out

    print("RPN port vs jit (image, other) x (share, L2):", worst(port, r["grads"]))
    print("RPN heads share:", _share(r["got"]["seg_softmax"], r["want"]["seg_softmax"]))
    rc = _rcnn_forward_pair(write_handoff(KittiDataset(torch_presets.rcnn_unittest()
                                                       .dataset_config, "train"),
                                          tempfile.mkdtemp()))
    print("RCNN port vs jit:", worst({n: p.grad for n, p in rc["model"].named_parameters()},
                                     rc["grads"]))
    steps, _, lr = _rpn_two_steps()
    for i, st in enumerate(steps):
        n = sum(int((_update_noise((st["port_grads"][k] - g).abs(),
                                   st["jax"][1]["state"]["nu"][k], i + 1, lr) >= 2 * lr).sum())
                for k, g in st["jax_grads"].items() if not _bn_followed(k))
        print(f"step {i + 1}: {n} elements at the 2 x lr cap; gradients",
              worst(st["port_grads"], st["jax_grads"]))
    jcfg, _ = _bf16_configs(_configs())
    model, args = _jax_rpn("train", jcfg, _batches()[0])
    v = random_variables(lambda: model.init(jax.random.PRNGKey(0), *args, training=False), 11)

    def f(params):
        preds, _ = model.apply({"params": params, "batch_stats": v["batch_stats"]}, *args,
                               training=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(1),
                                     "path_drop": jax.random.PRNGKey(2)})
        return j_rpn.rpn_loss(preds, jcfg.model_config)[1]

    with jax.disable_jit():
        eager = flax_to_state_dict(jax.grad(f)(as_jax(v["params"])))
    print("RPN JAX eager vs jit:", worst(eager, r["grads"]))
    print("RPN port vs JAX eager:", worst(port, eager))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    precision_report()
