"""Fused inference XConv.

Port of heterofusionrcnn_tpu/ops/pallas_xconv.py (`fused_xconv`): the whole
XConv block after the KNN (neighbour gather, the two lift DenseBNs, the
K x K X-transform, X applied to [lifted coords | neighbour features], the
composed separable conv, ELU and the folded output BatchNorm), through the
custom op `hfr::fused_xconv` (the weights flattened to a list of tensors
in `XConvWeights`' field order). On CUDA tensors it launches the kernel of
`csrc/xconv.cu`, which gathers the neighbours itself, keeps every
(P, K, C) intermediate on chip and runs the separable conv on the tensor
cores in 3xTF32; on CPU tensors `fused_xconv_plain` runs the same algebra
with PyTorch ops.

The kernel takes the composed weight Wc as its GEMM's B operand, arranged
by `xconv_weight_operand` (8-channel chunks in the kernel's contraction
order, split into two TF32 parts, cut into wgmma B tiles). `XConv` keeps
it with its folded weights (`XConvWeights.wc_operand`) until a weight
changes; weights built without it are arranged per call. `plan_xconv`
chooses, inside the op on the card it runs on, how many blocks split the
contraction of the few-query layers; a split's partial sums go through
`hfr::xconv_split_epilogue`.

`compute_dtype` bf16 is the Pallas kernel's `compute_dtype=jnp.bfloat16`
(the bf16 serving path): the op then takes bf16 features and returns bf16,
the card runs the bf16 entry of `csrc/xconv.cu` (`hfr_xconv_bf16`, the
kernel of `csrc/xconv_bf16.cuh`: warp-specialised `wgmma` bf16 products
with float32 sums on a persistent grid of clusters that form each A chunk
once for all output channels, Wc arranged by `xconv_weight_operand_bf16`
and kept in `XConvWeights.wc_operand_bf16`) and the CPU the plain
version's bf16 form; they round to bf16 exactly where the Pallas kernel
casts to its compute dtype.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F_

from heterofusionrcnn_torch.ops.conv import arrange_b
from heterofusionrcnn_torch.ops.dispatch import I, P, CudaKernel, one_device, pointers, sm_count
from heterofusionrcnn_torch.ops.grouping import group_point

XCONV_KERNEL = CudaKernel("xconv.cu", {"hfr_xconv": [P] * 24 + [I] * 11}, exact=False)
# The second kernel of the split path, in the same library, counted apart.
XCONV_EPILOGUE_KERNEL = CudaKernel("xconv.cu", {"hfr_xconv_epilogue": [P] * 4 + [I] * 3},
                                   exact=False, name="xconv_epilogue")
# The bf16 entries of the same library, counted apart.
XCONV_BF16_KERNEL = CudaKernel("xconv.cu", {"hfr_xconv_bf16": [P] * 24 + [I] * 11},
                               exact=False, name="xconv_bf16")
XCONV_EPILOGUE_BF16_KERNEL = CudaKernel(
    "xconv.cu", {"hfr_xconv_epilogue_bf16": [P] * 4 + [I] * 3}, exact=False,
    name="xconv_epilogue_bf16")
DTYPES = (torch.float32, torch.bfloat16)

_KERNEL_K = (4, 8, 12)
MAX_CF = 256          # lifted channels the kernel stages (kMaxCf)
CHUNK = 8             # input channels per chunk (kCC)
BLOCK_Q = 64          # queries per block (kBM)
BLOCK_D = 256         # output channels per block (kBN)
D_ALIGN = 128         # output channels of the arranged weight padded to this (kWN)
MIN_SPLIT_CHUNKS = 4  # chunks a split takes at least
MAX_SPLITS = 16
H100_SMS = 132
# The bf16 kernel (xconv_bf16.cuh): a cluster of CTAs per tile of BLOCK_Q
# queries covers all of D, each CTA two consumer warpgroups of
# `bf16_tile_n(D)` channels; contraction chunks of 16 channels.
BF16_CHUNK = 16       # kKC
BF16_MAX_D = 1024     # kMaxD


def bf16_tile_n(d: int) -> int:
    """Output channels of one consumer warpgroup of the bf16 kernel (WN):
    128 where D <= 256 (one CTA of 256), else 256."""
    return 128 if d <= 256 else 256


def bf16_cluster(d: int) -> int:
    """CTAs of the bf16 kernel's cluster along D: 2 WN channels each."""
    return -(-d // (2 * bf16_tile_n(d)))


@dataclass
class XConvWeights:
    """Inference weights of one XConv, BatchNorms folded to y = x * s + t.

    w1 (3, Cf), w2 (Cf, Cf): lift Dense kernels; wx0 (3K, K*K): X_0 Dense
    kernel; wx1, wx2 (K, K, K): X_1/X_2 depthwise kernels (None without the
    X-transform); wc (K, Cin, D): depthwise x pointwise composition of the
    separable conv, Cin = Cf + Cp with the lifted channels first."""

    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    wc: torch.Tensor
    sc: torch.Tensor
    bc: torch.Tensor
    wx0: Optional[torch.Tensor] = None
    sx0: Optional[torch.Tensor] = None
    bx0: Optional[torch.Tensor] = None
    wx1: Optional[torch.Tensor] = None
    sx1: Optional[torch.Tensor] = None
    bx1: Optional[torch.Tensor] = None
    wx2: Optional[torch.Tensor] = None
    sx2: Optional[torch.Tensor] = None
    bx2: Optional[torch.Tensor] = None
    wc_operand: Optional[torch.Tensor] = None  # xconv_weight_operand(wc, Cf), on the card
    wc_operand_bf16: Optional[torch.Tensor] = None  # xconv_weight_operand_bf16(wc, Cf)

    @property
    def with_x(self) -> bool:
        return self.wx0 is not None


def _chunks(n: int) -> int:
    return -(-n // CHUNK)


def chunk_order(nf: int, nch: int) -> List[int]:
    """The kernel's contraction schedule (`lifted_at`): at position p the
    chunk 0 .. nf - 1 (lifted channels 8 i ..) or nf + j (feature channels
    8 j ..); the lifted chunks sit at positions floor(i nch / nf)."""
    order = []
    for p in range(nch):
        i = -(-p * nf // nch)
        order.append(i if i < nf and i * nch // nf == p else nf + p - i)
    return order


def xconv_gemm_weight(wc: torch.Tensor, cf: int) -> torch.Tensor:
    """The kernel's B operand (K', Dp) from Wc (K, Cin, D), Cin = Cf + Cp:
    contraction rows in the kernel's order (8-channel chunk in the order of
    `chunk_order`, neighbour k, channel in chunk), the lifted and the
    feature channels each padded to a multiple of 8, and D padded to
    D_ALIGN, all with zeros."""
    k, cin, d = wc.shape
    cp = cin - cf
    nf, nc = _chunks(cf), _chunks(cf) + _chunks(cp)
    dp = -(-d // D_ALIGN) * D_ALIGN
    w = wc.new_zeros(k, CHUNK * nc, dp)
    w[:, :cf, :d] = wc[:, :cf]
    w[:, CHUNK * nf:CHUNK * nf + cp, :d] = wc[:, cf:]
    w = w.reshape(k, nc, CHUNK, dp)[:, chunk_order(nf, nc)]
    return w.permute(1, 0, 2, 3).reshape(-1, dp)


def xconv_weight_operand(wc: torch.Tensor, cf: int) -> torch.Tensor:
    """What `csrc/xconv.cu` takes for Wc: `xconv_gemm_weight` split into
    TF32 big and small parts and cut into wgmma B tiles (`ops/conv.py`,
    `arrange_b`)."""
    return arrange_b(xconv_gemm_weight(wc, cf))


def xconv_weight_operand_bf16(wc: torch.Tensor, cf: int) -> torch.Tensor:
    """What the bf16 kernel takes for Wc (K, Cin, D), Cin = Cf + Cp: Wc
    (composed in float32) rounded to bf16 as (Dp / WN, chunks, K, 2, WN,
    8), WN = `bf16_tile_n(D)`: [consumer tile of WN output channels][16-
    channel chunk in the order of `chunk_order`][neighbour][half of the
    chunk][output channel][channel in the half]. Each (chunk, neighbour)
    B tile of a consumer is one contiguous run of WN x 16 values, K-major
    as its `wgmma` reads it (8 x 8 core matrices of 128 bytes, the two
    halves WN x 16 bytes apart). Lifted and feature channels are each
    padded to a multiple of 16 and D to `bf16_cluster(D)` x 2 WN, with
    zeros."""
    k, cin, d = wc.shape
    cp = cin - cf
    nf = -(-cf // BF16_CHUNK)
    nc = nf + -(-cp // BF16_CHUNK)
    wn = bf16_tile_n(d)
    dp = bf16_cluster(d) * 2 * wn
    w = wc.new_zeros(k, BF16_CHUNK * nc, dp)
    w[:, :cf, :d] = wc[:, :cf]
    w[:, BF16_CHUNK * nf:BF16_CHUNK * nf + cp, :d] = wc[:, cf:]
    w = w.reshape(k, nc, BF16_CHUNK, dp)[:, chunk_order(nf, nc)]
    w = w.reshape(k, nc, 2, 8, dp // wn, wn).permute(4, 1, 0, 2, 5, 3)
    return w.to(torch.bfloat16).contiguous()


@dataclass(frozen=True)
class XConvPlan:
    """The kernel's grid: query tiles x channel tiles x contraction splits
    (the bf16 kernel's channel tiles are the CTAs of its cluster, which
    walk the query tiles and splits as a persistent grid)."""

    qtiles: int
    ntiles: int
    splits: int
    cluster: int = 1

    @property
    def blocks(self) -> int:
        return self.qtiles * self.ntiles * self.splits


def plan_xconv(nq: int, k: int, cf: int, cp: int, d: int, num_sms: int = H100_SMS,
               compute_dtype: torch.dtype = torch.float32) -> XConvPlan:
    """Tiles of BLOCK_Q queries x BLOCK_D channels, one block each (a block
    fills an SM). Where they number fewer than the SMs, the contraction's
    8-channel chunks are split over the fewest blocks that fill every SM,
    each split keeping at least MIN_SPLIT_CHUNKS chunks and at most
    MAX_SPLITS splits (`split_chunks` cuts them; the schedule of
    `chunk_order` gives each its share of lifted chunks). `k` does not
    change the float32 plan: every neighbour of a chunk stays in one split.
    The bf16 kernel's chunks are 16 channels wide; its clusters of
    `bf16_cluster(d)` CTAs walk (query tile, split) items as a persistent
    grid of num_sms // cluster clusters, so where the query tiles fill
    fewer, the contraction is split into as many parts as still fit in one
    round (at most MAX_SPLITS, MIN_SPLIT_CHUNKS chunks each)."""
    if compute_dtype == torch.bfloat16:
        qtiles, cluster = -(-nq // BLOCK_Q), bf16_cluster(d)
        nch = -(-cf // BF16_CHUNK) + -(-cp // BF16_CHUNK)
        most = max(1, min(MAX_SPLITS, nch // MIN_SPLIT_CHUNKS))
        clusters = max(1, num_sms // cluster)
        splits = min(most, clusters // qtiles) if qtiles < clusters else 1
        return XConvPlan(qtiles, cluster, splits, cluster)
    block_d, align, chunk = BLOCK_D, D_ALIGN, CHUNK
    qtiles = -(-nq // BLOCK_Q)
    ntiles = -(-(-(-d // align) * align) // block_d)
    base = qtiles * ntiles
    nch = -(-cf // chunk) + -(-cp // chunk)
    most = max(1, min(MAX_SPLITS, nch // MIN_SPLIT_CHUNKS))
    splits = min(most, -(-num_sms // base)) if base < num_sms else 1
    return XConvPlan(qtiles, ntiles, splits)


def split_chunks(nchunks: int, splits: int) -> List[Tuple[int, int]]:
    """The schedule positions [begin, end) of each split, as the kernel
    forms them."""
    return [(z * nchunks // splits, (z + 1) * nchunks // splits) for z in range(splits)]


def fused_xconv(
    pts: torch.Tensor,
    fts: Optional[torch.Tensor],
    qrs: torch.Tensor,
    idx: torch.Tensor,
    w: XConvWeights,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """XConv forward at inference.

    Args:
      pts: (B, N, 3) source points; fts: (B, N, Cp) source features in
        `compute_dtype`, or None.
      qrs: (B, P, 3) query points; idx: (B, P, K) int32 neighbour indices.
      w: folded float32 weights; `w.wc_operand` (`w.wc_operand_bf16` in
        bf16), where set, must be `xconv_weight_operand(w.wc, Cf)`
        (`xconv_weight_operand_bf16`; arranged here otherwise).
      compute_dtype: float32 or bf16.
    Returns:
      (B, P, D) in `compute_dtype`.
    """
    return torch.ops.hfr.fused_xconv(pts, fts, qrs, idx, [getattr(w, f.name) for f in fields(w)],
                                     compute_dtype)


@torch.library.custom_op("hfr::fused_xconv", mutates_args=(), device_types="cpu")
def _xconv_op(pts: torch.Tensor, fts: Optional[torch.Tensor], qrs: torch.Tensor,
              idx: torch.Tensor, weights: List[Optional[torch.Tensor]],
              compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return fused_xconv_plain(pts, fts, qrs, idx, XConvWeights(*weights), compute_dtype)


@_xconv_op.register_kernel("cuda")
def _xconv_cuda(pts: torch.Tensor, fts: Optional[torch.Tensor], qrs: torch.Tensor,
                idx: torch.Tensor, weights: List[Optional[torch.Tensor]],
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    w = XConvWeights(*weights)
    one_device(pts, fts, qrs, idx, *weights)
    b, n, _ = pts.shape
    _, p, k = idx.shape
    cf = w.w1.shape[1]
    cp = 0 if fts is None else fts.shape[-1]
    d = w.wc.shape[2]
    if k not in _KERNEL_K or d % 4 or cf > MAX_CF:
        raise ValueError(f"xconv kernel takes K in {_KERNEL_K}, D % 4 == 0 and Cf <= {MAX_CF}, "
                         f"got K={k} D={d} Cf={cf}")
    if w.wc.shape[1] != cf + cp:
        raise ValueError(f"weights for Cin={w.wc.shape[1]}, inputs give {cf + cp}")
    if compute_dtype == torch.bfloat16 and d > BF16_MAX_D:
        raise ValueError(f"bf16 xconv kernel takes D <= {BF16_MAX_D}, got D={d}")
    _check_dtypes(pts, fts, qrs, w, compute_dtype)
    nq = b * p
    plan = plan_xconv(nq, k, cf, cp, d, sm_count(pts.device), compute_dtype)
    if plan.splits > 1:
        partial = torch.empty((plan.splits, nq, d), dtype=torch.float32, device=pts.device)
        _launch_xconv(pts, fts, qrs, idx, w, None, partial, plan.splits, compute_dtype)
        return xconv_split_epilogue(partial, w.sc, w.bc, compute_dtype).reshape(b, p, d)
    out = torch.empty((b, p, d), dtype=compute_dtype, device=pts.device)
    _launch_xconv(pts, fts, qrs, idx, w, out, None, 1, compute_dtype)
    return out


@_xconv_op.register_fake
def _xconv_fake(pts: torch.Tensor, fts: Optional[torch.Tensor], qrs: torch.Tensor,
                idx: torch.Tensor, weights: List[Optional[torch.Tensor]],
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    one_device(pts, fts, qrs, idx, *weights)
    wc = XConvWeights(*weights).wc
    return pts.new_empty((idx.shape[0], idx.shape[1], wc.shape[2]), dtype=compute_dtype)


def _check_dtypes(pts, fts, qrs, w: XConvWeights, compute_dtype) -> None:
    """Coordinates and weights float32, features in the compute dtype."""
    if compute_dtype not in DTYPES:
        raise ValueError(f"xconv kernel computes in float32 or bf16, got {compute_dtype}")
    for name, t in vars(w).items():
        if t is not None and name != "wc_operand_bf16" and t.dtype != torch.float32:
            raise ValueError(f"xconv kernel takes float32 weights, got {t.dtype} for {name}")
    for t in (pts, qrs):
        if t.dtype != torch.float32:
            raise ValueError(f"xconv kernel takes float32 coordinates, got {t.dtype}")
    if fts is not None and fts.dtype != compute_dtype:
        raise ValueError(f"xconv kernel in {compute_dtype} takes features in it, got {fts.dtype}")


def _launch_xconv(pts, fts, qrs, idx, w: XConvWeights, out, partial, splits: int,
                  compute_dtype: torch.dtype) -> None:
    """One launch of `csrc/xconv.cu`, its float32 entry (`hfr_xconv`, Wc
    as `xconv_weight_operand`) or its bf16 entry (`hfr_xconv_bf16`: bf16
    features, the float32 weights rounded to bf16 in the kernel, Wc as
    `xconv_weight_operand_bf16`): the result into `out` (splits == 1) or
    the splits' float32 partial sums into `partial`."""
    b, n, _ = pts.shape
    _, p, k = idx.shape
    cf = w.w1.shape[1]
    cp = 0 if fts is None else fts.shape[-1]
    pts, qrs, idx = pts.contiguous(), qrs.contiguous(), idx.to(torch.int32).contiguous()
    fts = None if fts is None else fts.contiguous()
    if compute_dtype == torch.bfloat16:
        wt = w.wc_operand_bf16
        wt = xconv_weight_operand_bf16(w.wc, cf) if wt is None else wt
        kernel, fn, dp = XCONV_BF16_KERNEL, "hfr_xconv_bf16", wt.shape[0] * wt.shape[4]
    else:
        wt = w.wc_operand if w.wc_operand is not None else xconv_weight_operand(w.wc, cf)
        kernel, fn, dp = XCONV_KERNEL, "hfr_xconv", wt.shape[2] * 8
    ws = [w.w1, w.s1, w.b1, w.w2, w.s2, w.b2, w.wx0, w.sx0, w.bx0,
          w.wx1, w.sx1, w.bx1, w.wx2, w.sx2, w.bx2, wt, w.sc, w.bc]
    ws = [None if t is None else t.contiguous() for t in ws]
    # Whole 16-byte gathers: rows of a multiple of 16 bytes, aligned.
    vec = int(fts is not None and cp * fts.element_size() % 16 == 0 and fts.data_ptr() % 16 == 0)
    kernel.launch(
        fn, *pointers(pts, fts, qrs, idx, *ws, out, partial),
        I(b), I(n), I(p), I(k), I(cf), I(cp), I(w.wc.shape[2]), I(dp),
        I(int(w.with_x)), I(splits), I(vec),
    )


def xconv_split_epilogue(partial: torch.Tensor, sc: torch.Tensor, bc: torch.Tensor,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """BNc(ELU(sum of the splits)) of (S, M, D) float32 partial sums -> (M,
    D) in `out_dtype` (float32, or bf16 after the bf16 kernel): the second
    kernel of the split path on CUDA tensors (splits summed in order), the
    plain version on CPU tensors (`hfr::xconv_split_epilogue`)."""
    return torch.ops.hfr.xconv_split_epilogue(partial, sc, bc, out_dtype)


@torch.library.custom_op("hfr::xconv_split_epilogue", mutates_args=(), device_types="cpu")
def _epilogue_op(partial: torch.Tensor, sc: torch.Tensor, bc: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return xconv_split_epilogue_plain(partial, sc, bc, out_dtype)


@_epilogue_op.register_kernel("cuda")
def _epilogue_cuda(partial: torch.Tensor, sc: torch.Tensor, bc: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    one_device(partial, sc, bc)
    s, m, d = partial.shape
    if d % 4 or partial.dtype != torch.float32 or out_dtype not in DTYPES:
        raise ValueError(f"split epilogue takes float32 with D % 4 == 0 into float32 or bf16, "
                         f"got {partial.dtype}, D={d}, {out_dtype}")
    out = torch.empty((m, d), dtype=out_dtype, device=partial.device)
    kernel, fn = ((XCONV_EPILOGUE_BF16_KERNEL, "hfr_xconv_epilogue_bf16")
                  if out_dtype == torch.bfloat16 else (XCONV_EPILOGUE_KERNEL, "hfr_xconv_epilogue"))
    kernel.launch(fn, *pointers(partial.contiguous(), sc.contiguous(), bc.contiguous(), out),
                  I(s), I(m), I(d))
    return out


@_epilogue_op.register_fake
def _epilogue_fake(partial: torch.Tensor, sc: torch.Tensor, bc: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    one_device(partial, sc, bc)
    return partial.new_empty(partial.shape[1:], dtype=out_dtype)


def xconv_split_epilogue_plain(partial, sc, bc, out_dtype=torch.float32) -> torch.Tensor:
    out = partial[0]
    for z in range(1, partial.shape[0]):
        out = out + partial[z]
    return (F_.elu(out) * sc + bc).to(out_dtype)


def xconv_gemm_operand(pts, fts, qrs, idx, w: XConvWeights) -> torch.Tensor:
    """(X @ in) of the plain version, (B, P, K, Cin): the A operand of the
    separable conv's GEMM (contraction (k, c), k-major)."""
    b, p, k = idx.shape
    local = group_point(pts, idx) - qrs[:, :, None, :]  # (B, P, K, 3)
    h = F_.elu(local @ w.w1) * w.s1 + w.b1
    f2 = F_.elu(h @ w.w2) * w.s2 + w.b2
    fin = f2 if fts is None else torch.cat([f2, group_point(fts, idx)], dim=-1)
    if w.with_x:
        x0 = F_.elu(local.reshape(b, p, 3 * k) @ w.wx0) * w.sx0 + w.bx0
        x1 = torch.einsum("bpkc,kcj->bpcj", x0.reshape(b, p, k, k), w.wx1)
        x1 = F_.elu(x1.reshape(b, p, k * k)) * w.sx1 + w.bx1
        x2 = torch.einsum("bpkc,kcj->bpcj", x1.reshape(b, p, k, k), w.wx2)
        x2 = x2.reshape(b, p, k * k) * w.sx2 + w.bx2
        fin = torch.einsum("bpkj,bpjc->bpkc", x2.reshape(b, p, k, k), fin)
    return fin


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest even) and widened back to float32."""
    return t.to(torch.bfloat16).float()


def xconv_gemm_operand_bf16(pts, fts, qrs, idx, w: XConvWeights) -> torch.Tensor:
    """`xconv_gemm_operand` in the bf16 form, rounded to bf16 exactly where
    `pallas_xconv._xconv_kernel` casts to its compute dtype (float32 sums of
    bf16 products, float32 affines): the local coordinates before lift-1
    and X_0, the lift-1 output before lift-2, X_0 and X_1 before the next
    depthwise, and the (X @ in) stack; every weight once. The lifted
    features f2 and X_2 stay float32, the gathered features are bf16."""
    b, p, k = idx.shape
    local = _bf16(group_point(pts, idx) - qrs[:, :, None, :])  # (B, P, K, 3)
    h = _bf16(F_.elu(local @ _bf16(w.w1)) * w.s1 + w.b1)
    f2 = F_.elu(h @ _bf16(w.w2)) * w.s2 + w.b2
    fin = f2 if fts is None else torch.cat([f2, group_point(fts, idx).float()], dim=-1)
    if w.with_x:
        x0 = _bf16(F_.elu(local.reshape(b, p, 3 * k) @ _bf16(w.wx0)) * w.sx0 + w.bx0)
        x1 = torch.einsum("bpkc,kcj->bpcj", x0.reshape(b, p, k, k), _bf16(w.wx1))
        x1 = _bf16(F_.elu(x1.reshape(b, p, k * k)) * w.sx1 + w.bx1)
        x2 = torch.einsum("bpkc,kcj->bpcj", x1.reshape(b, p, k, k), _bf16(w.wx2))
        x2 = x2.reshape(b, p, k * k) * w.sx2 + w.bx2
        fin = torch.einsum("bpkj,bpjc->bpkc", x2.reshape(b, p, k, k), fin)
    return _bf16(fin)


def fused_xconv_plain(pts, fts, qrs, idx, w: XConvWeights,
                      compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the fused XConv (same algebra as the kernel
    and as `pallas_xconv.fused_xconv`), in float32 or in the bf16 form
    (`xconv_gemm_operand_bf16`; the output rounded to bf16)."""
    b, p, k = idx.shape
    if compute_dtype == torch.bfloat16:
        fin = xconv_gemm_operand_bf16(pts, fts, qrs, idx, w)
        out = fin.reshape(b, p, -1) @ _bf16(w.wc).reshape(-1, w.wc.shape[2])
        return (F_.elu(out) * w.sc + w.bc).to(torch.bfloat16)
    fin = xconv_gemm_operand(pts, fts, qrs, idx, w)
    cin = fin.shape[-1]
    out = fin.reshape(b, p, k * cin) @ w.wc.reshape(k * cin, -1)
    return F_.elu(out) * w.sc + w.bc
