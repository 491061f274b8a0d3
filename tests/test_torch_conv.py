"""The port's fused 3x3 conv and transposed conv (`ops/conv.py`) against the
JAX package's Pallas kernels, run as their own tests run them on the CPU
(`interpret=True`, float32 compute), and the VGG pyramid with the switch on
against the JAX module under `HFR_PALLAS_CONV=1` / `HFR_PALLAS_CONV_INTERPRET=1`.

Layouts: the JAX functions take NHWC and HWIO kernels, the port NCHW with
the `nn.Conv2d` (OIHW) and `nn.ConvTranspose2d` weights (the flax kernel
flipped in both spatial axes, as `convert.py` stores it).

The kernels' GEMMs (`csrc/conv.cu`, `csrc/convt.cu`) are mirrored in torch:
im2col in the kernel's K order, the wrapper's real weight operand (arranged
and split into TF32 parts), one matmul. The 3xTF32 numerics are emulated
on the CPU at the widest K of the VGG (9 x 256).

Tolerances: the functions and the GEMM mirrors 1e-5 (one conv, FP32 sums
in another order); the modules 1e-4, as in tests/test_torch_layers.py; the
delta-input tap tables and the weight arrangement exact; the 3xTF32
emulation against the card's gate, 1e-4 + 1e-4 |plain|.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
    conv_gemm_weight,
    conv_weight_operand,
    convt_gemm_weight,
    convt_weight_operand,
    convtranspose3x3_affine_relu,
    convtranspose3x3_affine_relu_plain,
    split_tf32,
    tf32_round,
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
    kernel's GEMM weight (`conv_gemm_weight`, K = (ci, tap) for Cin < 8)
    read back as a direct conv."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((6, 9)).astype(np.float32)
    wt = rng.standard_normal((1, 1, 3, 3)).astype(np.float32)
    plain = convtranspose3x3_affine_relu_plain(torch.from_numpy(x)[None, None], torch.from_numpy(wt),
                                               torch.ones(1), torch.zeros(1), relu=False)
    np.testing.assert_allclose(plain[0, 0].numpy(), _polyphase(x, wt[0, 0]), **FN_TOL)
    w = rng.standard_normal((4, 2, 3, 3)).astype(np.float32)
    xc = rng.standard_normal((2, 6, 9)).astype(np.float32)
    wg = conv_gemm_weight(torch.from_numpy(w)).numpy()  # the kernel's B, rows k = 9 ci + tap
    xp = np.pad(xc, ((0, 0), (1, 1), (1, 1)))
    direct = sum(xp[ci, dy:dy + 6, dx:dx + 9, None] * wg[9 * ci + 3 * dy + dx, :4]
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


# --- The tensor-core kernels' GEMMs, mirrored in torch -----------------------

CARD_ATOL = CARD_RTOL = 1e-4  # the card's gate, chip_smoke.py / test_torch_cuda.py
GEMM_SHAPES = [(1, 5, 7, 3, 8), (2, 9, 15, 3, 32), (1, 6, 11, 5, 40), (2, 9, 15, 32, 16),
               (1, 7, 9, 20, 72), (1, 4, 5, 8, 8)]


def _conv_case(seed, b, h, w, cin, cout, transpose):
    x, k, scale, shift = _case(seed, b, h, w, cin, cout)
    wt = _convt_weight(k) if transpose else torch.from_numpy(
        np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    return _nchw(x), wt, torch.from_numpy(scale), torch.from_numpy(shift)


def _chunk_order(cols, cin):
    """(B, Cin, 9, H, W) tap columns -> (B * H * W, 9 Cp) in the kernels'
    chunked K order k = (9 c + tap) 8 + kk, channel 8 c + kk."""
    b, _, _, h, w = cols.shape
    cp = -(-cin // 8) * 8
    cols = F.pad(cols, (0, 0, 0, 0, 0, 0, 0, cp - cin))
    cols = cols.reshape(b, cp // 8, 8, 9, h, w).permute(0, 1, 3, 2, 4, 5)
    return cols.reshape(b, 9 * cp, h * w).transpose(1, 2).reshape(b * h * w, 9 * cp)


def _im2col_conv(x):
    """The conv kernel's A operand: (B * H * W, K), K as conv_gemm_weight
    orders it ((ci, tap) flattened and padded for Cin < 8)."""
    b, cin, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    cols = torch.stack([xp[:, :, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], 2)
    if cin >= 8:
        return _chunk_order(cols, cin)
    steps = -(-9 * cin // 8)
    cols = F.pad(cols.reshape(b, 9 * cin, h * w), (0, 0, 0, 8 * steps - 9 * cin))
    return cols.transpose(1, 2).reshape(b * h * w, 8 * steps)


def _im2col_convt(x):
    """The transposed conv kernel's A operand at input resolution: column
    (c, tap a * 3 + b, kk) holds channel 8 c + kk at row shift -1 for a = 2
    and column shift -1 for b = 2."""
    b, cin, h, w = x.shape
    xp = F.pad(x, (1, 0, 1, 0))
    cols = torch.stack([xp[:, :, 1 - (a == 2):1 - (a == 2) + h, 1 - (bb == 2):1 - (bb == 2) + w]
                        for a in range(3) for bb in range(3)], 2)
    return _chunk_order(cols, cin)


def unarrange_b(arr):
    """Inverse of `arrange_b`: the (K, N) big and small parts of the
    (K / 8, 2, N / 8, 2, 8, 4) operand."""
    ks, ng = arr.shape[0], arr.shape[2]

    def untile(t):
        return t.permute(0, 2, 4, 1, 3).reshape(8 * ks, 8 * ng)

    return untile(arr[:, 0]), untile(arr[:, 1])


def _gemm_3xtf32(a, operand):
    """a_small b_big + a_big b_small + a_big b_big as one matmul, on the
    wrapper's arranged weight."""
    b_big, b_small = unarrange_b(operand)
    a_big, a_small = split_tf32(a)
    return torch.cat([a_small, a_big, a_big], 1) @ torch.cat([b_big, b_small, b_big], 0)


def _affine(y, scale, shift, relu=True):
    y = y * scale[:, None, None] + shift[:, None, None]
    return F.relu(y) if relu else y


@pytest.mark.parametrize("b,h,w,cin,cout", GEMM_SHAPES)
def test_conv_gemm_mirror_matches_plain(b, h, w, cin, cout):
    """im2col in the kernel's K order x the arranged, split weight, one
    matmul: the conv kernel's arithmetic up to the order of its sums."""
    x, wt, scale, shift = _conv_case(20, b, h, w, cin, cout, transpose=False)
    y = _gemm_3xtf32(_im2col_conv(x), conv_weight_operand(wt))[:, :cout]
    got = _affine(y.reshape(b, h, w, cout).permute(0, 3, 1, 2), scale, shift)
    torch.testing.assert_close(got, conv3x3_affine_relu_plain(x, wt, scale, shift), **FN_TOL)


@pytest.mark.parametrize("b,h,w,cin,cout", GEMM_SHAPES)
def test_convt_phase_gemm_mirror_matches_plain(b, h, w, cin, cout):
    """The four phase GEMMs of the transposed conv kernel (K = the taps of
    the phase x Cin), written to their interleaved positions."""
    x, wt, scale, shift = _conv_case(21, b, h, w, cin, cout, transpose=True)
    a = _im2col_convt(x)
    operand = convt_weight_operand(wt)
    tap = (torch.arange(a.shape[1]) // 8) % 9
    y = torch.zeros(b, cout, 2 * h, 2 * w)
    for ey in range(2):
        for ex in range(2):
            sel = ((tap // 3 == 1) == bool(ey)) & ((tap % 3 == 1) == bool(ex))
            ks = sel.reshape(-1, 8)[:, 0]
            part = _gemm_3xtf32(a[:, sel], operand[ks])[:, :cout]
            y[:, :, ey::2, ex::2] = part.reshape(b, h, w, cout).permute(0, 3, 1, 2)
    want = convtranspose3x3_affine_relu_plain(x, wt, scale, shift)
    torch.testing.assert_close(_affine(y, scale, shift), want, **FN_TOL)


def test_3xtf32_meets_card_gate_where_1xtf32_misses():
    """At K = 9 x 256 with the card tests' value ranges (unit normal input,
    He-scaled weights), the 3xTF32 product stays within the card's gate of
    the FP32 conv; one TF32 product (a_big b_big) misses it, which is why
    the kernels take three."""
    rng = np.random.default_rng(22)
    cin, cout = 256, 32
    x = torch.from_numpy(rng.standard_normal((1, cin, 8, 8)).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3))
                           * np.sqrt(2.0 / (9 * cin))).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32))
    shift = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32))
    want = conv3x3_affine_relu_plain(x, wt, scale, shift)
    a, operand = _im2col_conv(x), conv_weight_operand(wt)
    assert a.shape[1] == 9 * cin

    def gate(y):
        got = _affine(y[:, :cout].reshape(1, 8, 8, cout).permute(0, 3, 1, 2), scale, shift)
        return (got - want).abs() <= CARD_ATOL + CARD_RTOL * want.abs()

    assert bool(gate(_gemm_3xtf32(a, operand)).all())
    one = tf32_round(a) @ unarrange_b(operand)[0]
    assert not bool(gate(one).all())


def test_tf32_round_is_nearest_ties_away():
    """cvt.rna.tf32.f32: 10 stored mantissa bits, ties away from zero."""
    ulp, half = 2.0 ** -10, 2.0 ** -11
    x = torch.tensor([1 + half, -(1 + half), 1 + half - 2.0 ** -23, 1 + ulp + half, 3.0, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0], dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    big, small = split_tf32(torch.tensor([1 + 2.0 ** -12 + 2.0 ** -20]))
    assert float(big) == 1.0 and float(small) == 2.0 ** -12 + 2.0 ** -20


def _from_gemm(wg, cin, cout, transpose):
    """Inverse of the K order: (K, N) -> the (Cout, Cin, 3, 3) conv or the
    (Cin, Cout, 3, 3) transposed conv weight, and (K, N) with that weight's
    entries zeroed (the padding left over)."""
    rest = wg.clone()
    if not transpose and cin < 8:
        w = wg[:9 * cin, :cout].t().reshape(cout, cin, 3, 3).clone()
        rest[:9 * cin, :cout] = 0
        return w, rest
    cp = -(-cin // 8) * 8
    full = wg.reshape(cp // 8, 9, 8, -1).permute(3, 0, 2, 1).reshape(-1, cp, 9)
    w = full[:cout, :cin].reshape(cout, cin, 3, 3).clone()
    full[:cout, :cin] = 0
    rest = full.reshape(-1, cp // 8, 8, 9).permute(1, 3, 2, 0).reshape(wg.shape)
    return (w.transpose(0, 1) if transpose else w), rest


@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "convt"])
@pytest.mark.parametrize("cin,cout", [(3, 32), (5, 8), (8, 64), (20, 40), (256, 128)])
def test_weight_operand_round_trips(transpose, cin, cout):
    """The arranged operand holds exactly the TF32 split of the GEMM weight
    in the kernel's K order, zero padding elsewhere, and big + small gives
    back the original weight to 2^-20 of each value."""
    rng = np.random.default_rng(23)
    shape = (cin, cout, 3, 3) if transpose else (cout, cin, 3, 3)
    wt = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    operand = (convt_weight_operand if transpose else conv_weight_operand)(wt)
    wg = (convt_gemm_weight if transpose else conv_gemm_weight)(wt)
    np_ = -(-cout // 64) * 64
    assert operand.shape == (wg.shape[0] // 8, 2, np_ // 8, 2, 8, 4) and wg.shape[1] == np_
    big, small = unarrange_b(operand)
    assert torch.equal(big, split_tf32(wg)[0]) and torch.equal(small, split_tf32(wg)[1])
    back, rest = _from_gemm(big + small, cin, cout, transpose)
    assert back.shape == wt.shape and not bool(rest.any())
    torch.testing.assert_close(back, wt, rtol=2.0 ** -20, atol=0)
    exact, _ = _from_gemm(wg, cin, cout, transpose)
    assert torch.equal(exact, wt)
