"""The tensor-core XConv's CPU-visible pieces: the arranged weight, a CPU
mirror of the kernel's 3xTF32 GEMM, the tile and split planner, and the
folded-weight cache of the `XConv` module.

The kernel itself runs only on the card (tests/test_torch_cuda.py, marker
`cuda`); what surrounds it is Python and is checked here. Tolerances:
the mirror is held to the card's gate, 1e-4 + 1e-4 |plain| of the plain
FP32 version; the module against the JAX package as tests/test_torch_layers.py
holds it (rtol 1e-4, atol 1e-4).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from heterofusionrcnn_tpu.models.extractors import pointcnn as j_pointcnn

from heterofusionrcnn_torch.convert import load_flax_variables
from heterofusionrcnn_torch.models.extractors import pointcnn as t_pointcnn
from heterofusionrcnn_torch.ops.conv import split_tf32, tf32_round
from heterofusionrcnn_torch.ops.grouping import knn_point
from heterofusionrcnn_torch.ops.xconv import (
    CHUNK,
    D_ALIGN,
    chunk_order,
    MAX_SPLITS,
    MIN_SPLIT_CHUNKS,
    fused_xconv_plain,
    plan_xconv,
    split_chunks,
    xconv_gemm_operand,
    xconv_gemm_weight,
    xconv_weight_operand,
)

from tests.test_torch_conv import unarrange_b
from tests.test_torch_cuda import _torch_weights, _xconv_params
from tests.test_torch_layers import TOL, as_jax, random_variables

CARD_ATOL = CARD_RTOL = 1e-4
H100_SMS = 132

# The 15 XConv calls of the batch-4 main-path forward (rpn_multiclass,
# rcnn_multiclass): queries B*P, K, Cf, Cin, D.
MAIN_PATH_CALLS = [
    (65536, 8, 64, 65, 256), (16384, 8, 64, 320, 256), (4096, 8, 64, 320, 512),
    (1024, 8, 128, 640, 1024), (256, 8, 256, 1280, 1024), (256, 8, 256, 1536, 1024),
    (1024, 8, 256, 1280, 1024), (4096, 8, 256, 1280, 512), (16384, 8, 128, 640, 256),
    (65536, 8, 64, 320, 256), (65536, 8, 64, 320, 256), (204800, 4, 128, 640, 512),
    (51200, 8, 128, 640, 512), (12800, 12, 128, 640, 1024), (3200, 12, 256, 1280, 1024),
]


def _chunks(n):
    return -(-n // CHUNK)


def _kernel_order(a, k, cf, cp):
    """(M, K, Cin) -> (M, K') in the kernel's contraction order (8-channel
    chunk, neighbour, channel), the lifted and the feature channels each
    padded to a multiple of 8 with zeros."""
    m = a.shape[0]
    nf, nc = _chunks(cf), _chunks(cf) + _chunks(cp)
    out = a.new_zeros(m, k, CHUNK * nc)
    out[:, :, :cf] = a[:, :, :cf]
    out[:, :, CHUNK * nf:CHUNK * nf + cp] = a[:, :, cf:]
    out = out.reshape(m, k, nc, CHUNK)[:, :, chunk_order(nf, nc)]
    return out.permute(0, 2, 1, 3).reshape(m, -1)


def _from_gemm(wg, k, cf, cp, d):
    """Inverse of `xconv_gemm_weight`: Wc (K, Cin, D) and the GEMM weight
    with those entries zeroed (the padding left over)."""
    nf, nc = _chunks(cf), _chunks(cf) + _chunks(cp)
    inv = np.argsort(chunk_order(nf, nc))
    full = wg.reshape(nc, k, CHUNK, -1)[inv].permute(1, 0, 2, 3).reshape(k, CHUNK * nc, -1).clone()
    wc = torch.cat([full[:, :cf, :d], full[:, CHUNK * nf:CHUNK * nf + cp, :d]], 1).clone()
    full[:, :cf, :d] = 0
    full[:, CHUNK * nf:CHUNK * nf + cp, :d] = 0
    return wc, full


@pytest.mark.parametrize("k,cf,cp,d", [
    (8, 64, 1, 256), (4, 128, 40, 132), (12, 20, 13, 100), (12, 256, 300, 1024), (8, 64, 0, 4),
])
def test_xconv_weight_operand_round_trips(k, cf, cp, d):
    """(a) The arranged operand holds exactly the TF32 split of the GEMM
    weight in the kernel's contraction order; un-arranging and un-ordering
    it gives Wc back exactly, and zeros elsewhere."""
    rng = np.random.default_rng(30)
    wc = torch.from_numpy(rng.standard_normal((k, cf + cp, d)).astype(np.float32))
    wg = xconv_gemm_weight(wc, cf)
    dp = -(-d // D_ALIGN) * D_ALIGN
    kk = k * CHUNK * (_chunks(cf) + _chunks(cp))
    assert wg.shape == (kk, dp)
    operand = xconv_weight_operand(wc, cf)
    assert operand.shape == (kk // 8, 2, dp // 8, 2, 8, 4)
    big, small = unarrange_b(operand)
    want_big, want_small = split_tf32(wg)
    assert torch.equal(big, want_big) and torch.equal(small, want_small)
    back, rest = _from_gemm(wg, k, cf, cp, d)
    assert torch.equal(back, wc) and not bool(rest.any())
    near, _ = _from_gemm(big + small, k, cf, cp, d)
    torch.testing.assert_close(near, wc, rtol=2.0 ** -20, atol=0)


def _mirror_case(k, cf, cp, d, b=1, p=64, seed=31):
    rng = np.random.default_rng(seed)
    n = 200
    w = _torch_weights(_xconv_params(rng, k, cf, cf + cp, 2, d), True)
    # He-scaled Wc, as the card test scales it (std 1 / sqrt(K Cin)).
    w.wc = w.wc / (w.wc.std() * np.sqrt(k * (cf + cp)))
    pts = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32))
    qrs = torch.from_numpy(rng.standard_normal((b, p, 3)).astype(np.float32))
    fts = torch.from_numpy(rng.standard_normal((b, n, cp)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, (b, p, k)).astype(np.int32))
    return (pts, fts, qrs, idx, w)


def _kernel_gemm(a, operand, group_rows=2 * CHUNK):
    """The kernel's product on the CPU: per group of two k-steps (16
    contraction rows) a_small b_big + a_big b_small + a_big b_big chained
    from zero, then added to the FP32 running sum."""
    b_big, b_small = unarrange_b(operand)
    a_big, a_small = split_tf32(a)
    acc = torch.zeros(a.shape[0], b_big.shape[1])
    for r in range(0, a.shape[1], group_rows):
        s = slice(r, r + group_rows)
        acc = acc + (a_small[:, s] @ b_big[s] + a_big[:, s] @ b_small[s] + a_big[:, s] @ b_big[s])
    return acc


def test_3xtf32_chain_meets_card_gate_where_1xtf32_misses():
    """(b) At RCNN layer 4's contraction (K 12, Cf 256, Cin 1280: 15360
    terms), the kernel's 3xTF32 GEMM with its chain of two k-steps, on the
    (X @ in) operand of the plain version in the kernel's order, stays
    within the card's gate of the plain FP32 XConv; one TF32 product
    (a_big b_big) misses it."""
    k, cf, cp, d = 12, 256, 1024, 64
    pts, fts, qrs, idx, w = _mirror_case(k, cf, cp, d)
    want = fused_xconv_plain(pts, fts, qrs, idx, w).reshape(-1, d)
    a = xconv_gemm_operand(pts, fts, qrs, idx, w).reshape(-1, k, cf + cp)
    a = _kernel_order(a, k, cf, cp)
    operand = xconv_weight_operand(w.wc, cf)
    assert a.shape[1] == unarrange_b(operand)[0].shape[0] == k * (cf + cp)

    def gate(pre):
        got = F.elu(pre[:, :d]) * w.sc + w.bc
        return (got - want).abs() <= CARD_ATOL + CARD_RTOL * want.abs()

    assert bool(gate(_kernel_gemm(a, operand)).all())
    one = tf32_round(a) @ unarrange_b(operand)[0]
    assert not bool(gate(one).all())


@pytest.mark.parametrize("with_x,cp", [(True, 37), (False, 16)])
def test_kernel_gemm_mirror_matches_plain(with_x, cp):
    """The mirror at a small width with a Cp that is not a multiple of 8:
    the kernel's contraction order and padding against the plain version."""
    k, cf, d = 8, 20, 36
    rng = np.random.default_rng(32)
    n, b, p = 120, 2, 50
    w = _torch_weights(_xconv_params(rng, k, cf, cf + cp, 2, d), with_x)
    pts = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32))
    qrs = torch.from_numpy(rng.standard_normal((b, p, 3)).astype(np.float32))
    fts = torch.from_numpy(rng.standard_normal((b, n, cp)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, (b, p, k)).astype(np.int32))
    a = _kernel_order(xconv_gemm_operand(pts, fts, qrs, idx, w).reshape(b * p, k, -1), k, cf, cp)
    pre = _kernel_gemm(a, xconv_weight_operand(w.wc, cf))[:, :d]
    got = (F.elu(pre) * w.sc + w.bc).reshape(b, p, d)
    torch.testing.assert_close(got, fused_xconv_plain(pts, fts, qrs, idx, w), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("nq,k,cf,cin,d", MAIN_PATH_CALLS)
def test_plan_fills_the_card(nq, k, cf, cin, d):
    """(c) Every main-path call gets at least one block per SM, or the most
    splits its contraction allows, and its splits cover the schedule's
    chunks exactly once, each with at least MIN_SPLIT_CHUNKS chunks and
    within two of every other split's count of lifted chunks."""
    cp = cin - cf
    plan = plan_xconv(nq, k, cf, cp, d, H100_SMS)
    nf, nch = _chunks(cf), _chunks(cf) + _chunks(cp)
    most = min(MAX_SPLITS, nch // MIN_SPLIT_CHUNKS)
    assert plan.qtiles * 64 >= nq and plan.ntiles * 256 >= d
    assert plan.blocks >= H100_SMS or plan.splits == most
    if plan.qtiles * plan.ntiles >= H100_SMS:
        assert plan.splits == 1
    ranges = split_chunks(nch, plan.splits)
    covered = [c for lo, hi in ranges for c in range(lo, hi)]
    assert covered == list(range(nch))
    assert all(hi - lo >= MIN_SPLIT_CHUNKS for lo, hi in ranges)
    order = chunk_order(nf, nch)
    lifted = [sum(order[c] < nf for c in range(lo, hi)) for lo, hi in ranges]
    assert max(lifted) - min(lifted) <= 2


@pytest.mark.parametrize("nf,nch", [(1, 1), (1, 9), (8, 9), (32, 160), (16, 84), (5, 5), (3, 1000)])
def test_chunk_order_spreads_lifted_chunks(nf, nch):
    """The schedule is a permutation that keeps the lifted chunks and the
    feature chunks each in order, the lifted ones at floor(i nch / nf)."""
    order = chunk_order(nf, nch)
    assert sorted(order) == list(range(nch))
    assert [p for p, c in enumerate(order) if c < nf] == [i * nch // nf for i in range(nf)]
    assert [c for c in order if c < nf] == list(range(nf))
    assert [c for c in order if c >= nf] == list(range(nf, nch))


def test_few_query_layers_split():
    """The RPN layers with 256 and 1024 queries split their contraction;
    the 200-block RCNN layer 4 does not."""
    for nq, k, cf, cin, d in MAIN_PATH_CALLS:
        plan = plan_xconv(nq, k, cf, cin - cf, d, H100_SMS)
        assert (plan.splits > 1) == (nq * -(-d // 256) < 64 * H100_SMS)
    assert plan_xconv(256, 8, 256, 1024, 1024, H100_SMS).blocks == 144


def test_weight_cache_hits_and_invalidates():
    """(d) `XConv` folds its weights once per weight version: a second
    forward reuses the fold; an in-place parameter change, an in-place
    BatchNorm statistic change and `convert.load_flax_variables` each force
    a new one; the outputs follow the weights (the last against JAX)."""
    rng = np.random.default_rng(33)
    b, n, p, k, cp = 2, 96, 32, 8, 5
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    fts = rng.standard_normal((b, n, cp)).astype(np.float32)
    qrs = pts[:, :p]
    _, idx = knn_point(k, torch.from_numpy(pts), torch.from_numpy(qrs))
    t_in = (torch.from_numpy(pts), torch.from_numpy(fts), torch.from_numpy(qrs), idx)
    mod = j_pointcnn.XConv(K=k, D=1, C=32, C_pts_fts=16, depth_multiplier=2)
    args = (jnp.asarray(pts), jnp.asarray(fts), jnp.asarray(qrs), False)
    v = random_variables(
        lambda: mod.init(jax.random.PRNGKey(0), *args, nn_idx=jnp.asarray(idx.numpy())), 5)
    ours = t_pointcnn.XConv(k, 1, 32, 16, cp, 2)
    load_flax_variables(ours, random_variables(
        lambda: mod.init(jax.random.PRNGKey(1), *args, nn_idx=jnp.asarray(idx.numpy())), 6))
    ours.eval()

    def run():
        with torch.no_grad():
            return ours(*t_in)

    def plain():
        with torch.no_grad():
            return fused_xconv_plain(*t_in[:3], idx[:, :, :k], ours.weights())

    first = run()
    folds = ours.weight_folds
    assert folds == 1
    assert torch.equal(run(), first) and ours.weight_folds == folds
    with torch.no_grad():
        ours.fts_conv.depthwise.mul_(1.5)
    second = run()
    assert ours.weight_folds == folds + 1 and not torch.equal(second, first)
    torch.testing.assert_close(second, plain(), rtol=0, atol=0)
    with torch.no_grad():
        ours.fts_conv.BatchNorm_0.running_var.add_(0.25)
    third = run()
    assert ours.weight_folds == folds + 2 and not torch.equal(third, second)
    assert torch.equal(run(), third) and ours.weight_folds == folds + 2
    load_flax_variables(ours, v)
    got = run()
    assert ours.weight_folds == folds + 3
    want = mod.apply(as_jax(v), *args, nn_idx=jnp.asarray(idx.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
