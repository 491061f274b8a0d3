"""The bf16 XConv kernel's CPU-visible pieces, on the CPU.

The kernel (`heterofusionrcnn_torch/ops/csrc/xconv_bf16.cuh`) runs only on
the card (tests/test_torch_cuda.py, marker `cuda`). What it reads is laid
out here in Python and checked against mirrors of the kernel's address
formulas: the arranged Wc (`xconv_weight_operand_bf16`) against the bulk
copy and the `wgmma` descriptor of each consumer's B tiles, the producer's
A slots and chunk schedule against a GEMM mirror held to the plain bf16
version, and the plan (query tiles, cluster, splits) against a walk of the
persistent grid in which every chunk of every item is built by exactly one
CTA of its cluster. Also `torch.library.opcheck` of the two XConv ops in
float32 and bf16, and the bf16 operand cache of the `XConv` module.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from heterofusionrcnn_torch.models.extractors import pointcnn as t_pointcnn
from heterofusionrcnn_torch.ops.xconv import (
    BF16_CHUNK,
    MAX_SPLITS,
    MIN_SPLIT_CHUNKS,
    XConvWeights,
    bf16_cluster,
    bf16_tile_n,
    chunk_order,
    fused_xconv_plain,
    plan_xconv,
    split_chunks,
    xconv_gemm_operand_bf16,
    xconv_weight_operand_bf16,
)

H100_SMS = 132
BF16 = torch.bfloat16

# The 15 XConv calls of the batch-4 main-path forward (rpn_multiclass,
# rcnn_multiclass): queries B*P, K, Cf, Cin, D.
MAIN_PATH_CALLS = [
    (65536, 8, 64, 65, 256), (16384, 8, 64, 320, 256), (4096, 8, 64, 320, 512),
    (1024, 8, 128, 640, 1024), (256, 8, 256, 1280, 1024), (256, 8, 256, 1536, 1024),
    (1024, 8, 256, 1280, 1024), (4096, 8, 256, 1280, 512), (16384, 8, 128, 640, 256),
    (65536, 8, 64, 320, 256), (65536, 8, 64, 320, 256), (204800, 4, 128, 640, 512),
    (51200, 8, 128, 640, 512), (12800, 12, 128, 640, 1024), (3200, 12, 256, 1280, 1024),
]


def _ring_slots(k: int) -> int:
    """A ring slots of the kernel (`Layout::R`)."""
    return 4 if k == 4 else 2


def _chunks(n: int) -> int:
    return -(-n // BF16_CHUNK)


def lifted_at(p: int, nf: int, nch: int) -> int:
    """The kernel's `lifted_at`: the lifted chunk at position p, or -1."""
    i = -(-p * nf // nch)
    return i if i < nf and i * nch // nf == p else -1


def producer_channels(p: int, nf: int, nch: int, cf: int, cp: int) -> np.ndarray:
    """Input channels (of Cin = Cf + Cp, -1 for padding) of the 16 columns
    the producer builds at chunk position p: lifted chunk i's channels
    16 i .., or feature chunk p - ceil(p nf / nch)'s Cf + 16 j .."""
    li = lifted_at(p, nf, nch)
    if li >= 0:
        c = 16 * li + np.arange(16)
        return np.where(c < cf, c, -1)
    c = (p - -(-p * nf // nch)) * 16 + np.arange(16)
    return np.where(c < cp, cf + c, -1)


def kernel_b_offset(nt, p, k, kk, n, *, K, nch, wn):
    """Element offset, in the arranged operand, of B(kk, n) of the (chunk
    position p, neighbour k) tile of consumer tile nt, as the kernel reads
    it: the bulk copy of the tile starts at ((nt nch + p) K + k) 16 WN
    values; the K-major, unswizzled descriptor (leading byte offset WN x 16
    between the k16 step's halves, stride 128 bytes between 8-row groups,
    16 bytes a row) reads (kk, n) at half kk / 8, row n, column kk % 8."""
    return (((nt * nch + p) * K + k) * wn * 16 + (kk // 8) * wn * 8 + n * 8 + kk % 8)


def kernel_a_offset(slot, k, q, grp, e, *, K):
    """Byte offset in the A ring at which the producer stores value e of
    the 4-channel group grp (chunk columns 4 grp + e) of query q and
    neighbour k: `soff + k (64 x 32) + (grp >> 1)(64 x 16) + (grp & 1) 8`,
    soff = slot x 64 K x 32 + (q >> 3) 128 + (q & 7) 16, two bytes a value."""
    soff = slot * 64 * K * 32 + (q >> 3) * 128 + (q & 7) * 16
    return soff + k * 64 * 32 + (grp >> 1) * 64 * 16 + (grp & 1) * 8 + 2 * e


def descriptor_a_offset(slot, k, row, kk, *, K):
    """Byte offset of A(row, kk) of the (slot, neighbour k) product as the
    consumer's descriptor reads it: start slot x 64 K x 32 + k 2048, the
    k16 step's halves a leading byte offset of 1024 apart, 8-row groups a
    stride of 128 apart, 16 bytes a row of a core matrix."""
    start = slot * 64 * K * 32 + k * 2048
    return start + (kk // 8) * 1024 + (row // 8) * 128 + (row % 8) * 16 + (kk % 8) * 2


@pytest.mark.parametrize("k,cf,cp,d", [
    (8, 64, 1, 256), (4, 128, 40, 132), (12, 20, 13, 100), (12, 256, 300, 1024), (8, 64, 0, 4),
    (4, 128, 544, 512), (8, 16, 16, 300), (12, 128, 512, 1024),
])
def test_bf16_weight_operand_is_what_the_kernel_reads(k, cf, cp, d):
    """Every element of the arranged operand is read by exactly one
    (consumer tile, chunk position, neighbour, row, column) of the kernel,
    and holds bf16(Wc) of that neighbour, output channel and input channel
    (the producer's channel at that position), or zero for padding."""
    rng = np.random.default_rng(40)
    wc = torch.from_numpy(rng.standard_normal((k, cf + cp, d)).astype(np.float32))
    op = xconv_weight_operand_bf16(wc, cf)
    wn = bf16_tile_n(d)
    dp = 2 * wn * bf16_cluster(d)
    nf, nch = _chunks(cf), _chunks(cf) + _chunks(cp)
    assert op.dtype == BF16 and op.is_contiguous()
    assert op.shape == (dp // wn, nch, k, 2, wn, 8)
    flat = op.reshape(-1).float().numpy()
    want_all = wc.to(BF16).float().numpy()
    nt, p, kn, kk, n = np.meshgrid(np.arange(dp // wn), np.arange(nch), np.arange(k),
                                   np.arange(16), np.arange(wn), indexing="ij")
    off = kernel_b_offset(nt, p, kn, kk, n, K=k, nch=nch, wn=wn)
    assert np.array_equal(np.sort(off.reshape(-1)), np.arange(flat.size))  # each read once
    chans = np.stack([producer_channels(pp, nf, nch, cf, cp) for pp in range(nch)])  # (nch, 16)
    cin = chans[p, kk]
    col = nt * wn + n
    valid = (cin >= 0) & (col < d)
    want = np.zeros(off.shape, np.float32)
    want[valid] = want_all[kn[valid], cin[valid], col[valid]]
    np.testing.assert_array_equal(flat[off], want)


@pytest.mark.parametrize("nf,nch", [(1, 1), (4, 5), (8, 42), (16, 80), (8, 40), (4, 20)])
def test_producer_schedule_is_chunk_order(nf, nch):
    """The producer's position -> chunk formula is the schedule that
    arranges Wc (`chunk_order`): lifted chunk i or feature chunk nf + j."""
    order = chunk_order(nf, nch)
    for p in range(nch):
        li = lifted_at(p, nf, nch)
        assert order[p] == (li if li >= 0 else nf + p - -(-p * nf // nch))


@pytest.mark.parametrize("with_x", [True, False])
@pytest.mark.parametrize("k,cf,cp,d,b,p", [
    (4, 32, 40, 64, 1, 70), (8, 20, 13, 300, 2, 40), (12, 16, 0, 40, 1, 65), (8, 64, 20, 520, 1, 30),
])
def test_bf16_kernel_gemm_mirror_matches_plain(with_x, k, cf, cp, d, b, p):
    """The kernel's GEMM in mirror: the producer's A values (the plain
    version's rounded X @ in stacks, column by column at the channels of
    `producer_channels`) stored at `kernel_a_offset` into a slot and read
    back as the consumer's descriptor reads them, times B read at
    `kernel_b_offset`, summed chunk by chunk and neighbour by neighbour
    over the 64-query tiles and each consumer tile of the cluster: the
    plain bf16 version's sums, then its output, within one bf16 rounding."""
    from tests.test_torch_cuda import _torch_weights, _xconv_params

    rng = np.random.default_rng(41)
    n = 90
    w = _torch_weights(_xconv_params(rng, k, cf, cf + cp, 2, d), with_x)
    w.wc = w.wc / (w.wc.std() * np.sqrt(k * (cf + cp)))
    pts = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32))
    qrs = torch.from_numpy(rng.standard_normal((b, p, 3)).astype(np.float32))
    fts = torch.from_numpy(rng.standard_normal((b, n, cp)).astype(np.float32)).to(BF16) if cp else None
    idx = torch.from_numpy(rng.integers(0, n, (b, p, k)).astype(np.int32))
    fin = xconv_gemm_operand_bf16(pts, fts, qrs, idx, w).reshape(b * p, k, -1).numpy()
    op = xconv_weight_operand_bf16(w.wc, cf).reshape(-1).float().numpy()
    wn, cl = bf16_tile_n(d), bf16_cluster(d)
    nf, nch = _chunks(cf), _chunks(cf) + _chunks(cp)
    nq = b * p
    acc = np.zeros((-(-nq // 64) * 64, cl * 2 * wn), np.float64)
    slot = np.zeros(64 * k * 32, np.uint8)
    kk, nn = np.meshgrid(np.arange(16), np.arange(wn), indexing="ij")
    for q0 in range(0, nq, 64):
        for pos in range(nch):
            chans = producer_channels(pos, nf, nch, cf, cp)
            a = np.zeros((64, k, 16), np.float32)
            rows = np.arange(q0, min(q0 + 64, nq))
            for cc in range(16):
                if chans[cc] >= 0:
                    a[rows - q0, :, cc] = fin[rows, :, chans[cc]]
            # Store as the producer does, read as the consumer's descriptor does.
            q, kn, cc = np.meshgrid(np.arange(64), np.arange(k), np.arange(16), indexing="ij")
            bits = torch.from_numpy(a).to(BF16).view(torch.int16).numpy()
            slot[:] = 0
            slot.view(np.int16)[kernel_a_offset(1, kn, q, cc // 4, cc % 4, K=k) // 2 - 32 * k * 32] \
                = bits
            back = slot.view(np.int16)[descriptor_a_offset(1, kn, q, cc, K=k) // 2 - 32 * k * 32]
            back = torch.from_numpy(back.copy()).view(BF16).float().numpy()
            for kn1 in range(k):
                for nt in range(cl * 2):
                    bt = op[kernel_b_offset(nt, pos, kn1, kk, nn, K=k, nch=nch, wn=wn)]
                    acc[q0:q0 + 64, nt * wn:(nt + 1) * wn] += back[:, kn1, :] @ bt
    pre = torch.from_numpy(acc[:nq, :d].astype(np.float32))
    want_pre = torch.from_numpy(fin.reshape(nq, -1)) @ w.wc.to(BF16).float().reshape(-1, d)
    torch.testing.assert_close(pre, want_pre, rtol=1e-5, atol=1e-5)
    got = (F.elu(pre) * w.sc + w.bc).to(BF16).float()
    want = fused_xconv_plain(pts, fts, qrs, idx, w, BF16).reshape(nq, d).float()
    assert ((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-6).all()


def _walk(plan, nch, k, sms):
    """The persistent grid's walk: {(item, chunk position): rank} of the
    CTA whose producer builds it, and the ring slot of each, per cluster."""
    cl = plan.cluster
    items = plan.qtiles * plan.splits
    ncl = min(items, max(1, sms // cl))
    built = {}
    for cid in range(ncl):
        g = 0
        for item in range(cid, items, ncl):
            z = item // plan.qtiles
            cb, ce = z * nch // plan.splits, (z + 1) * nch // plan.splits
            for rank in range(cl):
                first = (rank - g % cl) % cl
                for pos in range(cb + first, ce, cl):
                    gc = g + pos - cb
                    assert gc % cl == rank and (gc % _ring_slots(k)) % cl == rank
                    assert (item, pos) not in built
                    built[(item, pos)] = rank
            g += ce - cb
    return built, items, ncl


@pytest.mark.parametrize("nq,k,cf,cin,d", MAIN_PATH_CALLS)
def test_bf16_plan_on_main_path(nq, k, cf, cin, d):
    """Query tiles of 64; one CTA for D <= 512 and a cluster of two for
    D 1024 (each CTA two consumer tiles of 256 channels, 128 at D 256);
    the contraction split only where the query tiles leave clusters idle,
    into as many splits as one round of the persistent grid holds, each
    of at least MIN_SPLIT_CHUNKS chunks; and the walk of the grid builds
    every chunk of every item exactly once, by the CTA that owns its slot."""
    cp = cin - cf
    plan = plan_xconv(nq, k, cf, cp, d, H100_SMS, BF16)
    nch = _chunks(cf) + _chunks(cp)
    assert plan.qtiles == -(-nq // 64)
    assert plan.cluster == plan.ntiles == {256: 1, 512: 1, 1024: 2}[d]
    assert bf16_tile_n(d) == (128 if d == 256 else 256)
    clusters = H100_SMS // plan.cluster
    if plan.qtiles >= clusters:
        assert plan.splits == 1
    else:
        assert plan.splits == min(MAX_SPLITS, nch // MIN_SPLIT_CHUNKS, clusters // plan.qtiles)
        assert plan.qtiles * plan.splits <= clusters
    ranges = split_chunks(nch, plan.splits)
    assert [c for lo, hi in ranges for c in range(lo, hi)] == list(range(nch))
    assert all(hi - lo >= MIN_SPLIT_CHUNKS for lo, hi in ranges)
    built, items, _ = _walk(plan, nch, k, H100_SMS)
    assert len(built) == plan.qtiles * nch and items == plan.qtiles * plan.splits


@pytest.mark.parametrize("nq,k,cf,cp,d,sms", [
    (150, 12, 128, 512, 1024, 132), (100, 12, 256, 1280, 1024, 132), (256, 8, 256, 1024, 1024, 132),
    (70, 8, 64, 0, 132, 132), (600, 4, 128, 544, 512, 20), (5000, 8, 64, 1, 256, 8),
    (64, 8, 16, 16, 1024, 132), (1, 4, 16, 0, 4, 132),
])
def test_bf16_plan_walk_covers_every_chunk_once(nq, k, cf, cp, d, sms):
    """Test-sized and edge shapes: a ragged query count, one query, Cp = 0,
    splits shorter than the cluster's walk, cards of few SMs."""
    plan = plan_xconv(nq, k, cf, cp, d, sms, BF16)
    nch = _chunks(cf) + _chunks(cp)
    assert 1 <= plan.splits <= nch and plan.cluster <= _ring_slots(k)
    assert _ring_slots(k) % plan.cluster == 0 and 2 * bf16_tile_n(d) * plan.cluster >= d
    built, _, _ = _walk(plan, nch, k, sms)
    assert sorted(built) == [(i, pos) for i in range(plan.qtiles * plan.splits)
                             for pos in range(i // plan.qtiles * nch // plan.splits,
                                              (i // plan.qtiles + 1) * nch // plan.splits)]


def _op_case(rng, dtype, with_x, cp):
    from tests.test_torch_cuda import _torch_weights, _xconv_params

    k, cf, d, b, n, p = 8, 16, 24, 2, 30, 10
    w = _torch_weights(_xconv_params(rng, k, cf, cf + cp, 2, d), with_x)
    pts = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32))
    qrs = torch.from_numpy(rng.standard_normal((b, p, 3)).astype(np.float32))
    fts = torch.from_numpy(rng.standard_normal((b, n, cp)).astype(np.float32)).to(dtype) if cp \
        else None
    idx = torch.from_numpy(rng.integers(0, n, (b, p, k)).astype(np.int32))
    return pts, fts, qrs, idx, [getattr(w, f) for f in XConvWeights.__dataclass_fields__]


@pytest.mark.parametrize("with_x,cp", [(True, 12), (False, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_opcheck_fused_xconv(dtype, with_x, cp):
    """opcheck of hfr::fused_xconv on the CPU (schema, fake against the CPU
    implementation, strides), and its output dtype and shape."""
    args = _op_case(np.random.default_rng(42), dtype, with_x, cp)
    torch.library.opcheck(torch.ops.hfr.fused_xconv.default, (*args, dtype))
    out = torch.ops.hfr.fused_xconv(*args, dtype)
    assert out.dtype == dtype and out.shape == (2, 10, 24) and out.is_contiguous()


@pytest.mark.parametrize("splits", [2, 5])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_opcheck_xconv_split_epilogue(dtype, splits):
    """opcheck of hfr::xconv_split_epilogue on the CPU: float32 partial sums
    into float32 or bf16."""
    rng = np.random.default_rng(43)
    partial = torch.from_numpy(rng.standard_normal((splits, 37, 24)).astype(np.float32))
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, 24).astype(np.float32))
    bc = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    torch.library.opcheck(torch.ops.hfr.xconv_split_epilogue.default, (partial, sc, bc, dtype))
    out = torch.ops.hfr.xconv_split_epilogue(partial, sc, bc, dtype)
    assert out.dtype == dtype and out.shape == (37, 24)


def test_bf16_operand_cache_follows_in_place_update(monkeypatch):
    """A bf16 `XConv` on the card keeps Wc arranged for the bf16 kernel
    (`wc_operand_bf16`) once per weight version: a second fold reuses it,
    an in-place update of a parameter rearranges it from the new Wc. The
    card is stood in for by `is_cuda` on the CPU tensors: the fold reads
    nothing else of the device."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    mod = t_pointcnn.XConv(8, 1, 32, 16, 5, 2, dtype=BF16)
    gen = torch.Generator().manual_seed(44)
    with torch.no_grad():  # seeded weights and BatchNorm statistics (variances positive)
        for name, t in [*mod.named_parameters(), *mod.named_buffers()]:
            if t.is_floating_point():
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5 if "var" in name
                        else torch.randn(t.shape, generator=gen) * 0.3)
    mod.eval()
    w = mod.kernel_weights()
    assert mod.weight_folds == 1 and w.wc_operand is None
    assert torch.equal(w.wc_operand_bf16, xconv_weight_operand_bf16(w.wc, w.w1.shape[1]))
    assert mod.kernel_weights() is w and mod.weight_folds == 1
    old = w.wc_operand_bf16.clone()
    with torch.no_grad():
        mod.fts_conv.depthwise.mul_(1.5)
    w2 = mod.kernel_weights()
    assert mod.weight_folds == 2 and w2 is not w
    assert torch.equal(w2.wc_operand_bf16, xconv_weight_operand_bf16(w2.wc, w2.w1.shape[1]))
    assert not torch.equal(w2.wc_operand_bf16, old)
