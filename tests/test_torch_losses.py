"""The training slice's building blocks against the JAX package on the CPU:
the losses and their gradients (`core/losses.py`), the RPN bin encoder and
the 3D IoU, the path-drop masks, BatchNorm in training, and the optimizer
against the optax chain of `runtime/optimizer.py`.

Inputs come from numpy seeds. Tolerances: forward values rtol 1e-4 /
atol 1e-5 (float32, other summation orders); gradients and updated
parameters rtol 1e-3 / atol 1e-5 (a gradient sums many products, and an
Adam update divides by the root of its second moment, which amplifies the
rounding of small gradients); integer bins exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from heterofusionrcnn_tpu.configs.config import OptimizerConfig as JaxOptimizerConfig
from heterofusionrcnn_tpu.core import bin_codec as j_codec
from heterofusionrcnn_tpu.core import losses as j_losses
from heterofusionrcnn_tpu.core.rotated_iou import box_3d_iou as j_box_3d_iou
from heterofusionrcnn_tpu.models.rpn import create_path_drop_masks as j_path_drop_masks
from heterofusionrcnn_tpu.runtime.optimizer import build_optimizer as j_build_optimizer
from heterofusionrcnn_tpu.runtime.optimizer import get_ema_params

from heterofusionrcnn_torch.configs.config import OptimizerConfig
from heterofusionrcnn_torch.core import bin_codec, losses
from heterofusionrcnn_torch.core.rotated_iou import box_3d_iou
from heterofusionrcnn_torch.models.extractors.layers import BatchNorm, BatchNorm2d
from heterofusionrcnn_torch.models.rpn import create_path_drop_masks
from heterofusionrcnn_torch.runtime.optimizer import Optimizer

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the tier-1 run has several workers a core
    set, and torch's spinning thread pools would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels(rng, shape, k):
    """Integer labels in [-1, k): -1 rows are the ignore label."""
    return rng.integers(-1, k, shape)


@pytest.mark.parametrize("name", ["smooth_l1", "softmax_ce", "focal", "focal_smoothed"])
def test_loss_and_gradient(name):
    rng = np.random.default_rng(0)
    k = 4
    if name == "smooth_l1":
        # Differences on both sides of |d| = 1.
        a = (rng.standard_normal((3, 7, 5)) * 1.5).astype(np.float32)
        b = (rng.standard_normal((3, 7, 5)) * 1.5).astype(np.float32)
        j_fn, t_fn = j_losses.weighted_smooth_l1, losses.weighted_smooth_l1
    else:
        a = rng.standard_normal((3, 7, k)).astype(np.float32) * 3
        labels = _labels(rng, (3, 7), k)
        if name == "focal_smoothed":
            b = np.array(j_losses.one_hot_smooth(jnp.asarray(labels), k, 0.05))
            np.testing.assert_allclose(
                losses.one_hot_smooth(torch.from_numpy(labels), k, 0.05).numpy(), b, **FWD)
        else:
            b = np.array(jax.nn.one_hot(labels, k))
            np.testing.assert_array_equal(losses.one_hot(torch.from_numpy(labels), k).numpy(), b)
        if name.startswith("focal"):
            a = np.array(jax.nn.softmax(jnp.asarray(a), axis=-1))
            j_fn, t_fn = j_losses.weighted_focal, losses.weighted_focal
        else:
            j_fn, t_fn = j_losses.weighted_softmax_ce, losses.weighted_softmax_ce
    want = j_fn(jnp.asarray(a), jnp.asarray(b), weight=2.5)
    want_grad = jax.grad(lambda x: jnp.sum(j_fn(x, jnp.asarray(b), weight=2.5) ** 2))(
        jnp.asarray(a))
    x = torch.tensor(a, requires_grad=True)
    got = t_fn(x, torch.from_numpy(b), weight=2.5)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **GRAD)


def test_encode_rpn():
    rng = np.random.default_rng(1)
    b, p, k = 2, 64, 3
    S = np.array([3.0, 3.0, 3.0], np.float32)
    DELTA = np.array([0.5, 0.5, 0.5], np.float32)
    R, dtheta = np.pi, 2 * np.pi / 12
    pts = rng.uniform(-20, 20, (b, p, 3)).astype(np.float32)
    boxes = np.concatenate([
        pts + rng.uniform(-4, 4, (b, p, 3)),        # offsets beyond +-S too
        rng.uniform(0.5, 4.0, (b, p, 3)),
        rng.uniform(-3.5, 3.5, (b, p, 1)),          # headings beyond +-R too
    ], -1).astype(np.float32)
    means = rng.uniform(0.5, 4.0, (b, p, 3)).astype(np.float32)
    want = j_codec.encode_rpn(jnp.asarray(pts), jnp.asarray(boxes), jnp.asarray(means),
                              S, DELTA, R, dtheta, k)
    got = bin_codec.encode_rpn(torch.from_numpy(pts), torch.from_numpy(boxes),
                               torch.from_numpy(means), S, DELTA, R, dtheta, k)
    for i, (g, w) in enumerate(zip(got, want)):
        if i in (0, 2, 4):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)


def test_box_3d_iou():
    """Batched (leading dim) pairwise 3D/BEV IoU of overlapping rotated
    boxes, against the JAX function vmapped over the batch."""
    rng = np.random.default_rng(2)

    def boxes(n):
        return np.concatenate([
            rng.uniform(-3, 3, (2, n, 3)), rng.uniform(0.5, 4.0, (2, n, 3)),
            rng.uniform(-np.pi, np.pi, (2, n, 1))], -1).astype(np.float32)

    a, b = boxes(40), boxes(9)
    b[:, :3] = a[:, :3]  # identical pairs
    want3, want2 = jax.vmap(j_box_3d_iou)(jnp.asarray(a), jnp.asarray(b))
    got3, got2 = box_3d_iou(torch.from_numpy(a), torch.from_numpy(b))
    assert got3.shape == (2, 40, 9)
    assert float(np.asarray(want3).max()) > 0.5
    np.testing.assert_allclose(got3.numpy(), np.asarray(want3), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,image", [(5, False), (16, False), (2, True)])
def test_batchnorm_training_matches_flax(n, image):
    """One training step of BatchNorm at n <= 16 values a channel: output,
    gradients and running statistics as flax (biased variance, E[x^2] -
    E[x]^2, momentum 0.99, epsilon 1e-3). torch's own training update
    (unbiased variance) differs by n / (n - 1) at these counts."""
    rng = np.random.default_rng(n)
    c = 6
    x = (rng.standard_normal((n, 3, 3, c) if image else (n, c)) * 2 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    mean0 = rng.standard_normal(c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    mod = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}

    def f(params, xx):
        y, upd = mod.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                           mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (_, (want, stats)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))

    bn = BatchNorm2d(c) if image else BatchNorm(c)
    with torch.no_grad():
        for t, val in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean0),
                       (bn.running_var, var0)):
            t.copy_(torch.from_numpy(val))
    bn.train()
    xt = torch.tensor(x, requires_grad=True)
    if image:
        got = bn(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    else:
        got = bn(xt)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), **FWD)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]), **GRAD)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]), **GRAD)

    ref = torch.from_numpy(var0).clone()
    flat = torch.from_numpy(x).reshape(-1, c)
    torch.nn.functional.batch_norm(flat, torch.from_numpy(mean0).clone(), ref, training=True,
                                   momentum=0.01, eps=1e-3)
    assert not np.allclose(ref.numpy(), np.asarray(stats["var"]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["adam", "momentum", "sgd", "rmsprop"])
def test_optimizer_matches_optax(kind):
    """Three updates against the JAX package's optax chain: the gradient's
    global norm above the clip (and once below it), the parameter EMA on,
    a staircase decay boundary crossed (decay_steps 2)."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    scales = (10.0, 0.01, 5.0)  # global norms ~50, ~0.05, ~25 against a clip of 1.5
    grads = [{k: (rng.standard_normal(s) * sc).astype(np.float32) for k, s in shapes.items()}
             for sc in scales]
    kw = dict(optimizer_type=kind, initial_learning_rate=0.01, decay_steps=2, decay_factor=0.5,
              staircase=True, momentum=0.8, use_moving_average=True, moving_average_decay=0.7)

    tx = j_build_optimizer(JaxOptimizerConfig(**kw), world_size=1, grad_clip_norm=1.5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ours = Optimizer(tp.items(), OptimizerConfig(**kw), world_size=1, grad_clip_norm=1.5)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        ours.step([torch.from_numpy(g[k]) for k in tp])
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **GRAD)
            np.testing.assert_allclose(ours.ema_state_dict()[k].numpy(),
                                       np.asarray(get_ema_params(opt_state)[k]), **GRAD)
    assert ours.count == 3
    assert float(ours.schedule(2)) == pytest.approx(0.005)


def test_optimizer_state_round_trip():
    """state_dict / load_state_dict carry the moments, the count and the
    EMA: a restored optimizer takes the same next step."""
    cfg = OptimizerConfig(use_moving_average=True)
    gen = torch.Generator().manual_seed(0)
    p1 = {"w": torch.randn(3, 4, generator=gen)}
    p2 = {"w": p1["w"].clone()}
    a = Optimizer(p1.items(), cfg)
    g = [torch.randn(3, 4, generator=gen) for _ in range(2)]
    a.step([g[0]])
    b = Optimizer(p2.items(), cfg)
    b.load_state_dict(a.state_dict())
    p2["w"].copy_(p1["w"])
    a.step([g[1]])
    b.step([g[1]])
    assert torch.equal(p1["w"], p2["w"]) and b.count == 2
    assert torch.equal(a.ema[0], b.ema[0])


@pytest.mark.parametrize("u", [(0.95, 0.3, 0.2), (0.3, 0.95, 0.7), (0.2, 0.1, 0.9),
                               (0.95, 0.97, 0.7), (0.95, 0.97, 0.3), (0.9, 0.9, 0.5)])
def test_path_drop_masks(u):
    """The path-drop masks from three uniforms at [0.9, 0.9]: one branch
    dropped, none, and both dropped with the third draw reviving one."""
    want = j_path_drop_masks(0.9, 0.9, jnp.asarray(u, jnp.float32))
    got = create_path_drop_masks(0.9, 0.9, torch.tensor(u))
    assert [float(g) for g in got] == [float(w) for w in want]
