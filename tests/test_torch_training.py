"""The port's training path against the JAX package's, at `rpn_unittest`
width on the CPU: one XConv in training (its unfused layers), the RPN in
train and val mode (predictions, `rpn_loss`, every parameter's gradient),
two whole train steps (`make_rpn_train_step`: Adam, clipping, EMA,
BatchNorm statistics), and the eval-mode port after them.

Flax variables are drawn at random from a seed and carried into the port by
`heterofusionrcnn_torch.convert`; JAX results (gradients, parameters and
statistics after steps) come back through the same converter. Both sides
get the port loader's batches of the fixture frames (real labels). Dropout
is 0 throughout; path drop runs once off ([1, 1]) and once with the same
three uniforms on both sides. The JAX PointCNN takes the direct-distance
KNN (tests/test_torch_layers.py).

Tolerances: forward values rtol 1e-4 / atol 1e-5 (boxes 5e-4 absolute,
as in tests/test_torch_models.py); gradients and parameters after steps
rtol 1e-3 / atol 1e-5 (each gradient sums over the whole batch through
the network, in another order on each side); indices exact. One kind of
tensor is held looser after steps: a bias that a training BatchNorm
follows (the image convs' biases, X_1's BatchNorm shift, which X_2's
training BatchNorm cancels) has a gradient of exactly 0 in exact
arithmetic, so its float32 gradient is rounding noise whose sign Adam
turns into an update of about the learning rate. Such a tensor is found
on the gradients of the steps, as one whose largest element stays below
1e-5 (at rpn_unittest these peak at 1.1e-6 and every other tensor's
largest element is 6.8e-3 or more), checked against those names, and
held within 2 x lr a step more; at rpn_unittest that is 18 tensors, 720
of 158,312 parameter elements (0.45%). Every other element is held at
1e-3 / 1e-5.
"""

from __future__ import annotations

import copy
import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heterofusionrcnn_tpu.configs import presets as jax_presets
from heterofusionrcnn_tpu.models import rpn as j_rpn
from heterofusionrcnn_tpu.models.extractors import pointcnn as j_pointcnn
from heterofusionrcnn_tpu.runtime.optimizer import build_optimizer as j_build_optimizer
from heterofusionrcnn_tpu.runtime.optimizer import get_ema_params
from heterofusionrcnn_tpu.runtime.train_state import TrainState as JaxTrainState
from heterofusionrcnn_tpu.runtime.train_state import make_rpn_train_step as j_make_step

from heterofusionrcnn_torch.configs import presets as torch_presets
from heterofusionrcnn_torch.convert import flax_to_state_dict, load_flax_variables
from heterofusionrcnn_torch.datasets.kitti.dataset import KittiDataset
from heterofusionrcnn_torch.inference import CLUSTER_SIZES
from heterofusionrcnn_torch.models.extractors import pointcnn as t_pointcnn
from heterofusionrcnn_torch.models.rpn import RpnModel, rpn_loss
from heterofusionrcnn_torch.ops.grouping import knn_point
from heterofusionrcnn_torch.runtime.optimizer import build_optimizer
from heterofusionrcnn_torch.runtime.train_state import (
    RPN_BATCH_KEYS,
    TrainState,
    make_rpn_train_step,
)

from tests.test_torch_layers import as_jax, direct_knn, random_variables

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
# A tensor whose gradient is below ZERO_GRAD in every element on every step
# is 0 in exact arithmetic; these are the names of such tensors.
ZERO_GRAD = 1e-5
BN_FOLLOWED_BIAS = re.compile(r"\.(Conv_0|ConvTranspose_0)\.bias$|\.X_1\.BatchNorm_0\.bias$")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the tier-1 run has several workers a core
    set, and torch's spinning thread pools would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or FWD))


def _configs(path_drop=(1.0, 1.0)):
    """rpn_unittest on both sides with dropout 0 and the given path drop."""
    out = []
    for cfg in (jax_presets.rpn_unittest(), torch_presets.rpn_unittest()):
        lc = cfg.model_config.layers_config
        for fc in lc.rpn_fc_layers + lc.pc_pointcnn.fc_layers:
            fc.dropout_rate = 0.0
        cfg.model_config.path_drop_probabilities = list(path_drop)
        out.append(cfg)
    return out


@functools.lru_cache(maxsize=1)
def _batches():
    """Two batches of 2 fixture frames from the port's train loader."""
    cfg = torch_presets.rpn_unittest()
    ds = KittiDataset(cfg.dataset_config, "train")
    ds.seed(0)
    ic = cfg.model_config.input_config
    out = []
    for _ in range(2):
        batch, _ = ds.next_batch(2, shuffle=True, model="rpn", pc_sample_pts=ic.pc_sample_pts,
                                 img_w=ic.img_dims_w, img_h=ic.img_dims_h)
        out.append(batch)
    assert all((b["label_seg"] > 0).sum() > 0 for b in out)
    return tuple(out)


def _state_dict_close(module, params, batch_stats, noise=None, **tol):
    """Every parameter and BatchNorm statistic of `module` against flax
    trees carried through the converter. `noise`: {name: atol} widening
    the tolerance of those whole tensors."""
    want = flax_to_state_dict(params, batch_stats)
    got = module.state_dict()
    for name, val in want.items():
        bound = tol["atol"] + tol["rtol"] * val.abs()
        if noise and name in noise:
            bound = bound + noise[name]
        assert bool(((got[name] - val).abs() <= bound).all()), (
            name, float((got[name] - val).abs().max()))
    return len(want)


def _grads_close(module, grads):
    want = flax_to_state_dict(grads)
    names = [n for n, _ in module.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **GRAD)


@pytest.mark.parametrize("with_global,cp", [(False, 5), (True, 12)])
def test_xconv_training(with_global, cp):
    """One XConv in training: output, the new BatchNorm statistics and the
    gradient of every parameter."""
    rng = np.random.default_rng(3)
    b, n, p, k = 2, 96, 32, 8
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    fts = rng.standard_normal((b, n, cp)).astype(np.float32)
    qrs = pts[:, :p]
    _, idx = knn_point(k, torch.from_numpy(pts), torch.from_numpy(qrs))
    mod = j_pointcnn.XConv(K=k, D=1, C=32, C_pts_fts=16, depth_multiplier=2,
                           with_global=with_global)
    args = (jnp.asarray(pts), jnp.asarray(fts), jnp.asarray(qrs))
    jidx = jnp.asarray(idx.numpy())
    v = random_variables(lambda: mod.init(jax.random.PRNGKey(0), *args, False, nn_idx=jidx), 4)
    cot = rng.standard_normal((b, p, 32 + (8 if with_global else 0))).astype(np.float32)

    def f(params):
        out, upd = mod.apply({"params": params, "batch_stats": v["batch_stats"]}, *args, True,
                             nn_idx=jidx, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd["batch_stats"])

    (_, (want, stats)), grads = jax.value_and_grad(f, has_aux=True)(as_jax(v["params"]))

    ours = t_pointcnn.XConv(k, 1, 32, 16, cp, 2, with_global=with_global)
    load_flax_variables(ours, v).train()
    got = ours(torch.from_numpy(pts), torch.from_numpy(fts), torch.from_numpy(qrs), idx)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got, want)
    assert _state_dict_close(ours, {}, stats, **FWD) > 0
    _grads_close(ours, grads)


def _uniforms_dropping_the_image():
    """A seed whose first three uniforms (torch.rand(3)) drop the image
    branch and keep the points at path drop [0.9, 0.9]."""
    for seed in range(100):
        u = torch.rand(3, generator=torch.Generator().manual_seed(seed))
        if u[0] >= 0.9 and u[1] < 0.9:
            return seed, u.numpy()
    raise AssertionError("no such seed")


def _jax_rpn(mode, jcfg, batch):
    model = j_rpn.RpnModel(config=jcfg.model_config, num_classes=3, cluster_sizes=CLUSTER_SIZES,
                           mode=mode)
    args = [jnp.asarray(batch[k]) for k in RPN_BATCH_KEYS]
    return model, args


@pytest.mark.parametrize("mode,path_drop", [("train", False), ("train", True), ("val", False)])
def test_rpn_loss_and_gradients(monkeypatch, mode, path_drop):
    """The RPN's predictions, its three losses and every parameter's
    gradient (and in train mode the new BatchNorm statistics)."""
    direct_knn(monkeypatch)
    jcfg, tcfg = _configs((0.9, 0.9) if path_drop else (1.0, 1.0))
    gens = None
    if path_drop:
        seed, u = _uniforms_dropping_the_image()
        orig = j_rpn.create_path_drop_masks
        monkeypatch.setattr(j_rpn, "create_path_drop_masks",
                            lambda p_img, p_pc, _: orig(p_img, p_pc, jnp.asarray(u)))
        gens = {"path_drop": torch.Generator().manual_seed(seed)}
    batch = _batches()[0]
    model, args = _jax_rpn(mode, jcfg, batch)
    v = random_variables(lambda: model.init(jax.random.PRNGKey(0), *args, training=False), 11)
    training = mode == "train"

    def f(params):
        preds, upd = model.apply({"params": params, "batch_stats": v["batch_stats"]}, *args,
                                 training=training, mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(1),
                                       "path_drop": jax.random.PRNGKey(2)})
        loss_dict, total = j_rpn.rpn_loss(preds, jcfg.model_config)
        return total, (loss_dict, preds, upd)

    (total, (loss_dict, want, upd)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        as_jax(v["params"]))

    ours = RpnModel(tcfg.model_config, 3, CLUSTER_SIZES, mode=mode)
    load_flax_variables(ours, v).train(training)
    got = ours(*(torch.from_numpy(batch[k]) for k in RPN_BATCH_KEYS), generators=gens)
    got_losses, got_total = rpn_loss(got, tcfg.model_config)
    got_total.backward()

    _close(got_total, total)
    for key, val in loss_dict.items():
        _close(got_losses[key], val)
    _close(got["seg_softmax"], want["seg_softmax"])
    np.testing.assert_array_equal(got["foreground_mask"].numpy(), np.asarray(want["foreground_mask"]))
    _close(got["seg_accuracy"], want["seg_accuracy"])
    for key in ("cls_preds", "reg_preds", "reg_gts"):
        for g, w in zip(got[key], want[key]):
            _close(g, w)
    for g, w in zip(got["cls_gts"], want["cls_gts"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _grads_close(ours, grads)
    if training:
        _state_dict_close(ours, {}, upd["batch_stats"], **FWD)
    else:
        _close(got["proposals"], want["proposals"], atol=5e-4, rtol=0)
        _close(got["proposal_scores"], want["proposal_scores"])
        np.testing.assert_array_equal(got["proposal_valid"].numpy(),
                                      np.asarray(want["proposal_valid"]))
        # IoUs against the real GT boxes of proposals of a sane size (random
        # weights also decode boxes of ~0 or negative size, whose IoUs
        # divide by a clamped ~0 union on both sides).
        real = np.arange(batch["label_boxes_3d"].shape[1]) < batch["label_num_boxes"][:, None]
        sane = (np.asarray(want["proposals"])[..., 3:6] > 0.1).all(-1)
        mask = sane[:, :, None] & real[:, None, :]
        assert mask.sum() > 100
        for key in ("proposal_iou3d", "proposal_iou2d"):
            np.testing.assert_allclose(got[key].detach().numpy()[mask], np.asarray(want[key])[mask],
                                       rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=1)
def _two_steps():
    """Two train steps on both sides from the same variables (EMA on):
    the JAX state after them, the port's state and metrics, the port
    module's weight folds before the steps, and each parameter's largest
    gradient element over the steps."""
    jcfg, tcfg = _configs()
    for cfg in (jcfg, tcfg):
        cfg.train_config.optimizer.use_moving_average = True
        cfg.train_config.optimizer.moving_average_decay = 0.9
    batches = _batches()
    model, args = _jax_rpn("train", jcfg, batches[0])
    v = random_variables(lambda: model.init(jax.random.PRNGKey(0), *args, training=False), 13)
    tx = j_build_optimizer(jcfg.train_config.optimizer, 1, jcfg.train_config.grad_clip_norm)
    jstate = JaxTrainState.create(model.apply, as_jax(v["params"]), as_jax(v["batch_stats"]), tx)
    jstep = j_make_step(lambda p: j_rpn.rpn_loss(p, jcfg.model_config))
    rng = jax.random.PRNGKey(100)
    jmetrics = []
    for batch in batches:
        jstate, m, rng = jstep(jstate, {k: jnp.asarray(batch[k]) for k in RPN_BATCH_KEYS}, rng)
        jmetrics.append(jax.tree_util.tree_map(np.asarray, m))

    ours = RpnModel(tcfg.model_config, 3, CLUSTER_SIZES, mode="train")
    load_flax_variables(ours, v)
    # An eval forward first, so that every XConv holds a weight fold that
    # the steps must make stale.
    ours.eval().mode = "test"
    with torch.no_grad():
        ours(*(torch.from_numpy(batches[0][k]) for k in RPN_BATCH_KEYS[:3]))
    folds = {n: m.weight_folds for n, m in ours.named_modules()
             if isinstance(m, t_pointcnn.XConv)}
    ours.mode = "train"
    opt = build_optimizer(ours, tcfg.train_config.optimizer, 1, tcfg.train_config.grad_clip_norm)
    state = TrainState.create(ours, opt, seed=0)
    loss_fn = lambda p: rpn_loss(p, tcfg.model_config)  # noqa: E731
    step = make_rpn_train_step(loss_fn)
    tmetrics, gmax = [], {}
    for b in batches:
        tb = {k: torch.from_numpy(b[k]) for k in RPN_BATCH_KEYS}
        probe = copy.deepcopy(ours).train()
        loss_fn(probe(*tb.values()))[1].backward()
        for n, p in probe.named_parameters():
            gmax[n] = max(gmax.get(n, 0.0), float(p.grad.abs().max()))
        tmetrics.append(step(state, tb))
    return jstate, jmetrics, state, tmetrics, folds, gmax


def test_two_train_steps(monkeypatch):
    """Two `make_rpn_train_step` steps against the JAX package's: the
    metrics of each step, then every parameter, BatchNorm statistic and
    EMA parameter, and the step count."""
    direct_knn(monkeypatch)
    jstate, jmetrics, state, tmetrics, _, gmax = _two_steps()
    for jm, tm in zip(jmetrics, tmetrics):
        assert sorted(jm) == sorted(tm)
        for key in jm:
            _close(tm[key], jm[key])
    assert state.step == int(jstate.step) == 2 and state.optimizer.count == 2
    # The tensors whose gradient is 0 in exact arithmetic (module
    # docstring): rounding noise on each side, whose sign Adam turns into
    # an update of about the learning rate, so they are held within 2 x lr
    # a step more. The rule picks out exactly the biases a training
    # BatchNorm follows.
    zero = {n for n, g in gmax.items() if g < ZERO_GRAD}
    assert zero == {n for n in gmax if BN_FOLLOWED_BIAS.search(n)}
    params = dict(state.model.named_parameters())
    assert (len(zero), sum(params[n].numel() for n in zero),
            sum(p.numel() for p in params.values())) == (18, 720, 158312)
    noise = {n: 2 * 2 * float(state.optimizer.schedule(0)) for n in zero}
    n = _state_dict_close(state.model, jax.tree_util.tree_map(np.asarray, jstate.params),
                          jax.tree_util.tree_map(np.asarray, jstate.batch_stats), noise, **GRAD)
    assert n == len(state.model.state_dict()) - sum(
        k.endswith("num_batches_tracked") for k in state.model.state_dict())
    want_ema = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                         get_ema_params(jstate.opt_state)))
    for name, val in state.ema.items():
        bound = GRAD["atol"] + GRAD["rtol"] * want_ema[name].abs() + noise.get(name, 0.0)
        assert bool(((val - want_ema[name]).abs() <= bound).all()), name


def test_eval_after_train_steps(monkeypatch):
    """After the steps the eval-mode port (fused XConv op, weights folded
    anew) matches the JAX test-mode RPN on the JAX state's new variables."""
    direct_knn(monkeypatch)
    jstate, _, state, _, folds, _ = _two_steps()
    jcfg, tcfg = _configs()
    batch = _batches()[1]
    model = j_rpn.RpnModel(config=jcfg.model_config, num_classes=3, cluster_sizes=CLUSTER_SIZES,
                           mode="test")
    args = [jnp.asarray(batch[k]) for k in RPN_BATCH_KEYS[:3]]
    want = jax.jit(lambda p, s, *a: model.apply({"params": p, "batch_stats": s}, *a,
                                                training=False))(
        jstate.params, jstate.batch_stats, *args)
    ours = state.model
    ours.eval().mode = "test"
    with torch.no_grad():
        got = ours(*(torch.from_numpy(batch[k]) for k in RPN_BATCH_KEYS[:3]))
    for name, m in ours.named_modules():
        if isinstance(m, t_pointcnn.XConv):
            assert m.weight_folds == folds[name] + 1, name
    _close(got["seg_softmax"], want["seg_softmax"])
    np.testing.assert_array_equal(got["proposal_valid"].numpy(), np.asarray(want["proposal_valid"]))
    _close(got["proposals"], want["proposals"], atol=5e-4, rtol=0)
    _close(got["proposal_scores"], want["proposal_scores"])


def test_module_copies_after_in_place_update():
    """An XConv that folded its weights stays copyable after a parameter
    changes in place (an optimizer step): the fold holds no views."""
    ours = t_pointcnn.XConv(8, 1, 32, 16, 5, 2)
    with torch.no_grad():
        ours.kernel_weights()
        ours.nn_fts_from_pts_0.Dense_0.weight.add_(1.0)
    twin = copy.deepcopy(ours)
    assert torch.equal(twin.nn_fts_from_pts_0.Dense_0.weight, ours.nn_fts_from_pts_0.Dense_0.weight)


def test_xconv_eval_paths(monkeypatch):
    """An eval-mode XConv runs the fused op under no_grad; with autograd on
    and parameters that need gradients it runs its layers one by one on the
    CPU, with the same output and a gradient for every parameter."""
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.standard_normal((2, 64, 3)).astype(np.float32))
    fts = torch.from_numpy(rng.standard_normal((2, 64, 5)).astype(np.float32))
    qrs = pts[:, :24]
    ours = t_pointcnn.XConv(8, 1, 32, 16, 5, 2).eval()
    fused, orig = [], t_pointcnn.fused_xconv
    monkeypatch.setattr(t_pointcnn, "fused_xconv", lambda *a: fused.append(1) or orig(*a))
    with torch.no_grad():
        want = ours(pts, fts, qrs)
    assert fused == [1]
    got = ours(pts, fts, qrs)
    assert fused == [1]
    _close(got, want.numpy())
    got.sum().backward()
    assert all(p.grad is not None for p in ours.parameters())
