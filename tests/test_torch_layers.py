"""The port's modules with weights carried over from the flax modules by
`heterofusionrcnn_torch.convert`: the point and conv layers
(ConvTransposeBNRelu among them), the VGG pyramid, XConv and PointCNN.

Flax variables are drawn at random from a seed for the shapes the flax
`init` would give (`jax.eval_shape`, so nothing is initialised twice):
kernels, biases and every BatchNorm scale/bias/mean/var, so the folds and
the converter's renames are exercised. The JAX PointCNN runs its KNN through
`pallas_knn._knn_reference_jnp` (the TPU kernel's direct-distance
semantics, which the port implements) instead of the CPU fallback's
matmul-expanded distance, whose rounding can swap near-equal neighbours.

Tolerances: f32 features atol/rtol 1e-4 (different summation orders
through stacked layers); sampled points exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heterofusionrcnn_tpu.configs.presets import rpn_unittest as jax_rpn_unittest
from heterofusionrcnn_tpu.models.extractors import img_vgg_pyr as j_vgg
from heterofusionrcnn_tpu.models.extractors import layers as j_layers
from heterofusionrcnn_tpu.models.extractors import pointcnn as j_pointcnn
from heterofusionrcnn_tpu.ops.pallas_knn import _knn_reference_jnp

from heterofusionrcnn_torch.configs.presets import rpn_unittest
from heterofusionrcnn_torch.convert import load_flax_variables
from heterofusionrcnn_torch.models.extractors import img_vgg_pyr as t_vgg
from heterofusionrcnn_torch.models.extractors import layers as t_layers
from heterofusionrcnn_torch.models.extractors import pointcnn as t_pointcnn
from heterofusionrcnn_torch.ops.grouping import knn_point

TOL = dict(rtol=1e-4, atol=1e-4)


def random_variables(init_fn, seed):
    """Numpy flax variables with the shapes `init_fn()` would return, drawn
    from `seed`: kernels glorot-normal with flax's fans (the kernel's last
    two axes times its receptive field), BN scales and variances
    U(0.5, 1.5), biases and BN means N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (rng.standard_normal(x.shape) * 0.1).astype(np.float32)
        receptive = int(np.prod(x.shape[:-2]))
        std = np.sqrt(2.0 / (receptive * (x.shape[-2] + x.shape[-1])))
        return (rng.standard_normal(x.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn))


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def direct_knn(monkeypatch):
    monkeypatch.setattr(j_pointcnn, "knn_point", _knn_reference_jnp)


@pytest.mark.parametrize("name", [
    "DenseBN", "ConvOverK", "DepthwiseConvOverK", "SeparableConvOverK", "ConvBNRelu",
])
def test_point_and_conv_layers(name):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)  # (B, P, K, C) / NHWC
    jmod, ours = {
        "DenseBN": (j_layers.DenseBN(7), t_layers.DenseBN(4, 7)),
        "ConvOverK": (j_layers.ConvOverK(9), t_layers.ConvOverK(5, 4, 9)),
        "DepthwiseConvOverK": (j_layers.DepthwiseConvOverK(3), t_layers.DepthwiseConvOverK(5, 4, 3)),
        "SeparableConvOverK": (j_layers.SeparableConvOverK(6, 2),
                               t_layers.SeparableConvOverK(5, 4, 6, 2)),
        "ConvBNRelu": (j_layers.ConvBNRelu(6), t_layers.ConvBNRelu(4, 6)),
    }[name]
    v = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), False), 8)
    want = jmod.apply(as_jax(v), jnp.asarray(x), False)
    load_flax_variables(ours, v).eval()
    t = torch.from_numpy(x)
    with torch.no_grad():
        got = ours(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) if name == "ConvBNRelu" else ours(t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv_transpose_bn_relu():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    mod = j_layers.ConvTransposeBNRelu(4)
    v = random_variables(lambda: mod.init(jax.random.PRNGKey(0), jnp.asarray(x), False), 1)
    want = mod.apply(as_jax(v), jnp.asarray(x), False)
    ours = load_flax_variables(t_layers.ConvTransposeBNRelu(6, 4), v).eval()
    got = ours(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cls,hw", [
    ("ImgVggPyr", (24, 40)), ("ImgVggPyr", (30, 44)), ("ImgVgg", (24, 40)), ("ImgVgg", (30, 44)),
])
def test_img_vgg_pyr(cls, hw):
    """Both image extractors: the VGG pyramid (its transposed convs and
    crops) and the plain VGG with its bilinear upsampling."""
    rng = np.random.default_rng(1)
    cfg = rpn_unittest().model_config.layers_config.img_vgg_pyr
    jcfg = jax_rpn_unittest().model_config.layers_config.img_vgg_pyr
    img = rng.uniform(0, 255, (1, *hw, 3)).astype(np.float32)
    mod = getattr(j_vgg, cls)(jcfg)
    x = j_vgg.preprocess_image(jnp.asarray(img))
    v = random_variables(lambda: mod.init(jax.random.PRNGKey(0), x, False), 2)
    want = jax.jit(lambda v_, x_: mod.apply(v_, x_, False))(as_jax(v), x)
    ours = load_flax_variables(getattr(t_vgg, cls)(cfg), v).eval()
    with torch.no_grad():
        got = ours(t_vgg.preprocess_image(torch.from_numpy(img)))
    c_out = cfg.vgg_conv1[1] if cls == "ImgVggPyr" else cfg.vgg_conv4[1]
    assert got.shape == (1, *hw, c_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("with_global,cp", [(False, 5), (True, 12)])
def test_xconv_module(with_global, cp):
    rng = np.random.default_rng(3)
    b, n, p, k = 2, 96, 32, 8
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    fts = rng.standard_normal((b, n, cp)).astype(np.float32)
    qrs = pts[:, :p]
    _, idx = knn_point(k, torch.from_numpy(pts), torch.from_numpy(qrs))
    mod = j_pointcnn.XConv(K=k, D=1, C=32, C_pts_fts=16, depth_multiplier=2,
                           with_global=with_global)
    args = (jnp.asarray(pts), jnp.asarray(fts), jnp.asarray(qrs), False)
    v = random_variables(
        lambda: mod.init(jax.random.PRNGKey(0), *args, nn_idx=jnp.asarray(idx.numpy())), 4)
    want = mod.apply(as_jax(v), *args, nn_idx=jnp.asarray(idx.numpy()))
    ours = t_pointcnn.XConv(k, 1, 32, 16, cp, 2, with_global=with_global)
    load_flax_variables(ours, v).eval()
    with torch.no_grad():
        got = ours(torch.from_numpy(pts), torch.from_numpy(fts), torch.from_numpy(qrs), idx)
    assert got.shape == (b, p, ours.out_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pointcnn_encoder_decoder(monkeypatch):
    """The rpn_unittest PointCNN (4 XConv + 4 XDConv, FPS, KNN cache)."""
    direct_knn(monkeypatch)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-20, 20, (2, 1024, 3)).astype(np.float32)
    inten = rng.uniform(-0.5, 0.5, (2, 1024, 1)).astype(np.float32)
    jcfg = jax_rpn_unittest().model_config.layers_config.pc_pointcnn
    mod = j_pointcnn.PointCNN(jcfg)
    args = (jnp.asarray(pts), jnp.asarray(inten), False)
    v = random_variables(lambda: mod.init(jax.random.PRNGKey(0), *args), 6)
    want_pts, want_fts = jax.jit(lambda v_, *a: mod.apply(v_, *a, False))(as_jax(v), *args[:2])
    ours = t_pointcnn.PointCNN(rpn_unittest().model_config.layers_config.pc_pointcnn, 1)
    load_flax_variables(ours, v).eval()
    with torch.no_grad():
        got_pts, got_fts = ours(torch.from_numpy(pts), torch.from_numpy(inten))
    np.testing.assert_array_equal(got_pts.numpy(), np.asarray(want_pts))
    np.testing.assert_allclose(got_fts.numpy(), np.asarray(want_fts), **TOL)
