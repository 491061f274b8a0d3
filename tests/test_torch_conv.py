"""The port's fused 3x3 conv and transposed conv (`ops/conv.py`) against the
JAX package's Pallas kernels, run as their own tests run them on the CPU
(`interpret=True`, float32 compute), and the VGG pyramid with the switch on
against the JAX module under `HFR_PALLAS_CONV=1` / `HFR_PALLAS_CONV_INTERPRET=1`.

Layouts: the JAX functions take NHWC and HWIO kernels, the port NCHW with
the `nn.Conv2d` (OIHW) and `nn.ConvTranspose2d` weights (the flax kernel
flipped in both spatial axes, as `convert.py` stores it).

Tolerances: the functions 1e-5 (one conv, FP32 sums in another order);
the modules 1e-4, as in tests/test_torch_layers.py; the delta-input tap
tables exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heterofusionrcnn_tpu.configs.config import ImgVggPyrConfig as JaxVggConfig
from heterofusionrcnn_tpu.models.extractors import img_vgg_pyr as j_vgg
from heterofusionrcnn_tpu.models.extractors import layers as j_layers
from heterofusionrcnn_tpu.ops.pallas_conv import conv3x3_affine_relu as jax_conv
from heterofusionrcnn_tpu.ops.pallas_convtranspose import (
    convtranspose3x3_affine_relu as jax_convt,
)

from heterofusionrcnn_torch.configs.config import ImgVggPyrConfig
from heterofusionrcnn_torch.convert import flax_to_state_dict, load_flax_variables
from heterofusionrcnn_torch.models.extractors import img_vgg_pyr as t_vgg
from heterofusionrcnn_torch.models.extractors import layers as t_layers
from heterofusionrcnn_torch.ops.conv import (
    conv3x3_affine_relu,
    conv3x3_affine_relu_plain,
    convtranspose3x3_affine_relu,
    convtranspose3x3_affine_relu_plain,
)

from tests.test_torch_layers import as_jax, random_variables

FN_TOL = dict(rtol=1e-5, atol=1e-5)
MOD_TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = [(1, 5, 7, 3, 8), (2, 9, 15, 32, 16), (1, 45, 150, 3, 8), (1, 23, 75, 32, 40)]


def _case(seed, b, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, k, scale, shift


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _convt_weight(k):
    """Flax ConvTranspose kernel (3, 3, Cin, Cout) -> the port's weight."""
    return torch.from_numpy(np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1)))


@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES)
def test_conv3x3_plain_matches_pallas(b, h, w, cin, cout):
    x, k, scale, shift = _case(10, b, h, w, cin, cout)
    want = jax_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(shift),
                    compute_dtype=jnp.float32, interpret=True)
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    got = conv3x3_affine_relu(_nchw(x), wt, torch.from_numpy(scale), torch.from_numpy(shift))
    assert got.shape == (b, cout, h, w)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **FN_TOL)


@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES)
def test_convtranspose3x3_plain_matches_pallas(b, h, w, cin, cout):
    x, k, scale, shift = _case(11, b, h, w, cin, cout)
    want = jax_convt(jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(shift),
                     compute_dtype=jnp.float32, interpret=True)
    got = convtranspose3x3_affine_relu(_nchw(x), _convt_weight(k), torch.from_numpy(scale),
                                       torch.from_numpy(shift))
    assert got.shape == (b, cout, 2 * h, 2 * w)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **FN_TOL)


def _polyphase(x, wt):
    """The tap table of csrc/convt.cu written out in numpy: x (H, W), wt
    (3, 3) in the port's orientation -> (2H, 2W)."""
    h, w = x.shape
    p = np.pad(x, ((1, 0), (1, 0)))
    x11, x10, x01, x00 = p[1:, 1:], p[1:, :-1], p[:-1, 1:], p[:-1, :-1]
    f = wt.reshape(-1)
    out = np.zeros((2 * h, 2 * w), np.float64)
    out[0::2, 0::2] = x11 * f[0] + x10 * f[2] + x01 * f[6] + x00 * f[8]
    out[0::2, 1::2] = x11 * f[1] + x01 * f[7]
    out[1::2, 0::2] = x11 * f[3] + x10 * f[5]
    out[1::2, 1::2] = x11 * f[4]
    return out


@pytest.mark.parametrize("i,j", [(0, 0), (2, 3), (4, 6)])
def test_convtranspose_delta_taps(i, j):
    """A delta at input (i, j) through a kernel of distinct taps: flax sends
    x[m] to y[2m + t] through k[2 - t] per axis. The Pallas kernel, the
    port's plain version and the kernel's tap table all place every tap
    there."""
    h, w = 5, 7
    x = np.zeros((1, h, w, 1), np.float32)
    x[0, i, j, 0] = 1.0
    k = np.arange(1, 10, dtype=np.float32).reshape(3, 3, 1, 1)
    want = np.zeros((2 * h, 2 * w), np.float32)
    for ty in range(3):
        for tx in range(3):
            if 2 * i + ty < 2 * h and 2 * j + tx < 2 * w:
                want[2 * i + ty, 2 * j + tx] = k[2 - ty, 2 - tx, 0, 0]
    one, zero = np.ones(1, np.float32), np.zeros(1, np.float32)
    pallas = jax_convt(jnp.asarray(x), jnp.asarray(k), jnp.asarray(one), jnp.asarray(zero),
                       relu=False, compute_dtype=jnp.float32, interpret=True)
    wt = _convt_weight(k)
    plain = convtranspose3x3_affine_relu_plain(_nchw(x), wt, torch.ones(1), torch.zeros(1),
                                               relu=False)
    np.testing.assert_array_equal(np.asarray(pallas)[0, :, :, 0], want)
    np.testing.assert_array_equal(plain[0, 0].numpy(), want)
    np.testing.assert_array_equal(_polyphase(x[0, :, :, 0], wt[0, 0].numpy()), want)


def test_conv_tap_table_matches_plain():
    """The transposed conv kernel's tap table on random data, and the conv
    kernel's weight layout (Cin, 3, 3, Cout) read back as a direct conv."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((6, 9)).astype(np.float32)
    wt = rng.standard_normal((1, 1, 3, 3)).astype(np.float32)
    plain = convtranspose3x3_affine_relu_plain(torch.from_numpy(x)[None, None], torch.from_numpy(wt),
                                               torch.ones(1), torch.zeros(1), relu=False)
    np.testing.assert_allclose(plain[0, 0].numpy(), _polyphase(x, wt[0, 0]), **FN_TOL)
    w = rng.standard_normal((4, 2, 3, 3)).astype(np.float32)
    xc = rng.standard_normal((2, 6, 9)).astype(np.float32)
    w_kernel = w.transpose(1, 2, 3, 0)  # what the wrapper hands the kernel
    xp = np.pad(xc, ((0, 0), (1, 1), (1, 1)))
    direct = sum(xp[ci, dy:dy + 6, dx:dx + 9, None] * w_kernel[ci, dy, dx]
                 for ci in range(2) for dy in range(3) for dx in range(3))
    got = conv3x3_affine_relu_plain(torch.from_numpy(xc)[None], torch.from_numpy(w),
                                    torch.ones(4), torch.zeros(4), relu=False)
    np.testing.assert_allclose(got[0].numpy(), direct.transpose(2, 0, 1), **FN_TOL)


@pytest.mark.parametrize("name", ["ConvBNRelu", "ConvTransposeBNRelu"])
def test_conv_modules_with_kernel_switch(monkeypatch, name):
    """The blocks with the switch on (BatchNorm and conv bias folded by
    `fold_bn_affine`) against the JAX blocks on their Pallas path, with
    random BN statistics and conv biases."""
    monkeypatch.setenv("HFR_PALLAS_CONV", "1")
    monkeypatch.setenv("HFR_PALLAS_CONV_INTERPRET", "1")
    x = np.random.default_rng(13).standard_normal((2, 9, 13, 6)).astype(np.float32)
    jmod = getattr(j_layers, name)(5)
    v = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), False), 14)
    want = jmod.apply(as_jax(v), jnp.asarray(x), False)
    ours = load_flax_variables(getattr(t_layers, name)(6, 5, conv_kernel=True), v).eval()
    with torch.no_grad():
        got = ours(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **MOD_TOL)
    s, t = t_layers.fold_bn_affine(*ours.children())
    sd = flax_to_state_dict(v["params"], v["batch_stats"])
    s_ref = sd["BatchNorm_0.weight"] / torch.sqrt(sd["BatchNorm_0.running_var"] + 1e-3)
    assert torch.equal(s, s_ref)
    conv_bias = next(k for k in sd if k.endswith("_0.bias") and not k.startswith("Batch"))
    t_ref = sd["BatchNorm_0.bias"] - sd["BatchNorm_0.running_mean"] * s_ref + sd[conv_bias] * s_ref
    torch.testing.assert_close(t, t_ref, rtol=0, atol=1e-7)


def test_img_vgg_pyr_with_kernel_switch(monkeypatch):
    """The whole VGG pyramid with the switch on, at odd sizes on every level
    (26x42 -> 13x21 -> 7x11 -> 4x6), against the JAX module's Pallas path."""
    monkeypatch.setenv("HFR_PALLAS_CONV", "1")
    monkeypatch.setenv("HFR_PALLAS_CONV_INTERPRET", "1")
    widths = dict(vgg_conv1=(2, 8), vgg_conv2=(2, 16), vgg_conv3=(3, 16), vgg_conv4=(3, 32))
    img = np.random.default_rng(15).uniform(0, 255, (1, 26, 42, 3)).astype(np.float32)
    mod = j_vgg.ImgVggPyr(JaxVggConfig(**widths))
    x = j_vgg.preprocess_image(jnp.asarray(img))
    v = random_variables(lambda: mod.init(jax.random.PRNGKey(0), x, False), 16)
    want = mod.apply(as_jax(v), x, False)
    ours = load_flax_variables(t_vgg.ImgVggPyr(ImgVggPyrConfig(**widths), conv_kernels=True), v)
    with torch.no_grad():
        got = ours.eval()(t_vgg.preprocess_image(torch.from_numpy(img)))
    assert got.shape == (1, 26, 42, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD_TOL)
