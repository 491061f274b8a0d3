"""Fused 3x3 convolutions of the VGG image branch: conv (or stride-2
transposed conv) + folded BatchNorm affine + ReLU, in float32 (NCHW) or in
bf16 (channels-last, the bf16 serving path).

Port of heterofusionrcnn_tpu/ops/pallas_conv.py `conv3x3_affine_relu` and
heterofusionrcnn_tpu/ops/pallas_convtranspose.py
`convtranspose3x3_affine_relu`, in the port's layouts: activations
(B, C, H, W), the conv weight (Cout, Cin, 3, 3) and the transposed conv weight
(Cin, Cout, 3, 3) as `nn.Conv2d` / `nn.ConvTranspose2d` hold them (the
latter flipped in both spatial axes against flax, see
`layers.ConvTransposeBNRelu`). CUDA tensors launch the kernels of
`csrc/conv.cu` and `csrc/convt.cu`, implicit GEMMs on the tensor cores in
3xTF32 (`csrc/conv_common.cuh`); CPU tensors run the plain versions; each
through its custom op (`hfr::conv3x3_affine_relu`,
`hfr::convtranspose3x3_affine_relu`). Any H and W are taken; the TPU's
tile-fit gate has no counterpart.

The activations' dtype picks the form, as the Pallas kernels'
`compute_dtype` does: float32 as above, or bf16 (`csrc/conv_bf16.cuh`, the
entries `hfr_conv3x3_bf16` / `hfr_convt3x3_bf16`): the input and the
weight rounded to bf16, float32 sums, the float32 affine and ReLU, a bf16
output. Any other dtype raises. Output layouts, the same in the CUDA
implementation, the CPU one and the fake: float32 NCHW-contiguous, bf16
channels-last (NHWC in memory, the Pallas kernel's layout, which the bf16
kernels load by TMA; `channels_last8` pads the channels to a multiple of 8
for them). The weight stays a float32 parameter; the bf16 kernels take it
rounded and arranged (`bf16_weight_operand`) once per weight version
(`cached_bf16_operand`).

The float32 kernels take the weight as their GEMM's B operand, arranged
inside the op's CUDA implementation once per call from the weight it is given
(`conv_weight_operand`, `convt_weight_operand`): K rows in the kernel's
order (`conv_gemm_weight`, `convt_gemm_weight`), each value split into two
TF32 parts (`split_tf32`), cut into wgmma B tiles (`arrange_b`).
"""

from __future__ import annotations

import weakref
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from heterofusionrcnn_torch.ops.dispatch import I, P, CudaKernel, one_device, pointers, sm_count

_ARGS = [P, P, P, P, P, I, I, I, I, I, I]
N_ALIGN = 64  # output channels of the arranged weight padded to this (kNAlign)
BF16_CHUNK = 16  # input channels per pipeline stage of the bf16 kernels (kKC)
CONV_KERNEL = CudaKernel("conv.cu", {"hfr_conv3x3": _ARGS}, exact=False)
CONVT_KERNEL = CudaKernel("convt.cu", {"hfr_convt3x3": _ARGS}, exact=False)
# The bf16 entries of the same libraries, counted apart; + the tile width
# and the SM count.
CONV_BF16_KERNEL = CudaKernel("conv.cu", {"hfr_conv3x3_bf16": _ARGS + [I, I]}, exact=False,
                              name="conv_bf16")
CONVT_BF16_KERNEL = CudaKernel("convt.cu", {"hfr_convt3x3_bf16": _ARGS + [I, I]}, exact=False,
                               name="convt_bf16")
DTYPES = (torch.float32, torch.bfloat16)


def _check(x, weight, scale, shift, cin_dim: int):
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"need x (B, C, H, W) and a 3x3 weight, got {tuple(x.shape)} "
                         f"and {tuple(weight.shape)}")
    if weight.shape[cin_dim] != x.shape[1]:
        raise ValueError(f"weight {tuple(weight.shape)} does not take {x.shape[1]} channels")
    cout = weight.shape[1 - cin_dim]
    if scale.shape != (cout,) or shift.shape != (cout,):
        raise ValueError(f"scale/shift must be ({cout},)")
    if x.dtype not in DTYPES or any(t.dtype != torch.float32 for t in (weight, scale, shift)):
        raise ValueError(f"conv kernels take float32 or bf16 activations and float32 weights, "
                         f"got {x.dtype} and {weight.dtype}")
    if x.numel() >= 2**31:
        raise ValueError("conv kernels take fewer than 2**31 input elements")
    return cout


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero on the 13 dropped bits: `cvt.rna.tf32.f32`."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor):
    """t = big + small up to ~2^-22 |t|: big = tf32(t), small = tf32(t - big)."""
    big = tf32_round(t)
    return big, tf32_round(t - big)


def _n_padded(cout: int) -> int:
    return -(-cout // N_ALIGN) * N_ALIGN


def _chunked_gemm_weight(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 9 taps) -> (K, N): K in (chunk of 8 input channels, tap,
    channel in chunk) order, Cin padded to a multiple of 8 and N to N_ALIGN
    with zeros."""
    cout, cin, _ = w.shape
    cp = -(-cin // 8) * 8
    w = F.pad(w, (0, 0, 0, cp - cin, 0, _n_padded(cout) - cout))
    return w.reshape(-1, cp // 8, 8, 9).permute(1, 3, 2, 0).reshape(9 * cp, -1)


def conv_gemm_weight(weight: torch.Tensor) -> torch.Tensor:
    """The conv kernel's B operand (K, N) from the (Cout, Cin, 3, 3) weight:
    for Cin >= 8 the chunked order of `_chunked_gemm_weight`; for Cin < 8
    k = ci * 9 + tap, 9 Cin rows padded to a multiple of 8."""
    cout, cin = weight.shape[:2]
    w = weight.reshape(cout, cin, 9)
    if cin >= 8:
        return _chunked_gemm_weight(w)
    steps = -(-9 * cin // 8)
    return F.pad(w.reshape(cout, 9 * cin).t(), (0, _n_padded(cout) - cout, 0, 8 * steps - 9 * cin))


def convt_gemm_weight(weight: torch.Tensor) -> torch.Tensor:
    """The transposed conv kernel's B operand (K, N) from the (Cin, Cout, 3, 3)
    weight, in the chunked order (tap a * 3 + b of the port's orientation)."""
    cin, cout = weight.shape[:2]
    return _chunked_gemm_weight(weight.reshape(cin, cout, 9).permute(1, 0, 2))


def arrange_b(wg: torch.Tensor) -> torch.Tensor:
    """(K, N) -> (K / 8, 2, N / 8, 2, 8, 4): per k-step of 8 rows, the big
    and the small TF32 part as wgmma B tiles (K-major, no swizzle):
    [ks][part][ng][h][r][c] = part of row k = 8 ks + 4 h + c, column
    n = 8 ng + r. One tile row holds 4 k of one output channel, 8 rows make
    a 128-byte core matrix (csrc/conv_common.cuh)."""
    k, n = wg.shape

    def tiles(m):
        return m.reshape(k // 8, 2, 4, n // 8, 8).permute(0, 3, 1, 4, 2)

    big, small = split_tf32(wg)
    return torch.stack([tiles(big), tiles(small)], 1).contiguous()


def bf16_tile_n(cout: int, transposed: bool) -> int:
    """Output channels of a bf16 kernel's tile (its wgmma N; kernel
    `Cfg`): 128, 64 or 32 for the conv, 64 or 32 for the transposed conv
    (four phases of accumulators)."""
    if cout > 64 and not transposed:
        return 128
    return 64 if cout > 32 else 32


def bf16_weight_operand(w9: torch.Tensor, bn: int) -> torch.Tensor:
    """What the bf16 kernels (`csrc/conv_bf16.cuh`) take for a (Cout, Cin,
    9 taps) weight and tiles of `bn` output channels: (Cout tiles, Cin
    chunks of 16, 9 taps, 2 groups of 8 channels, bn, 8) bf16,

        op[t, c, tap, g, n, j] = w9[t * bn + n, 16 c + 8 g + j, tap],

    zeros in the padding: per (Cout tile, chunk) the contiguous B slice of
    one pipeline stage, each tap's [group][output channel][8 channels] the
    K-major core matrices of a wgmma B operand."""
    cout, cin, _ = w9.shape
    cp = -(-cin // BF16_CHUNK) * BF16_CHUNK
    nt = -(-cout // bn)
    w = F.pad(w9, (0, 0, 0, cp - cin, 0, nt * bn - cout))
    w = w.reshape(nt, bn, cp // BF16_CHUNK, 2, 8, 9).permute(0, 2, 5, 3, 1, 4)
    return w.to(torch.bfloat16).contiguous()


def _weight9(weight: torch.Tensor, transposed: bool) -> torch.Tensor:
    """(Cout, Cin, 9 taps) from the conv's (Cout, Cin, 3, 3) or the
    transposed conv's (Cin, Cout, 3, 3) weight (tap a * 3 + b)."""
    a, b = weight.shape[:2]
    w9 = weight.reshape(a, b, 9)
    return w9.permute(1, 0, 2) if transposed else w9


# id(weight) -> (weak reference, key, operand): the bf16 operand of each
# live weight, re-arranged when the key changes.
_BF16_OPERANDS: Dict[int, Tuple[weakref.ref, tuple, torch.Tensor]] = {}


def cached_bf16_operand(weight: torch.Tensor, transposed: bool) -> torch.Tensor:
    """`bf16_weight_operand` of a float32 conv or transposed-conv weight,
    arranged once per weight version: kept while the weight lives, keyed
    by its `_version` (raised by every in-place update: an optimizer's
    step, `load_state_dict`, `copy_`), storage, shape, device and form.
    The entry goes with the weight (a weak reference), so a new tensor at a
    freed one's address never finds it. Inference tensors, which keep no
    version, are arranged per call."""
    bn = bf16_tile_n(weight.shape[1] if transposed else weight.shape[0], transposed)
    if weight.is_inference():
        return bf16_weight_operand(_weight9(weight, transposed), bn)
    key = (weight._version, weight.data_ptr(), tuple(weight.shape), weight.device, transposed, bn)
    wid = id(weight)
    hit = _BF16_OPERANDS.get(wid)
    if hit is not None and hit[0]() is weight and hit[1] == key:
        return hit[2]
    with torch.no_grad():
        op = bf16_weight_operand(_weight9(weight, transposed), bn)

    def drop(ref, cache=_BF16_OPERANDS):
        if wid in cache and cache[wid][0] is ref:
            del cache[wid]

    _BF16_OPERANDS[wid] = (weakref.ref(weight, drop), key, op)
    return op


def conv_weight_operand(weight: torch.Tensor) -> torch.Tensor:
    """What `csrc/conv.cu` takes for the (Cout, Cin, 3, 3) weight."""
    return arrange_b(conv_gemm_weight(weight))


def convt_weight_operand(weight: torch.Tensor) -> torch.Tensor:
    """What `csrc/convt.cu` takes for the (Cin, Cout, 3, 3) weight."""
    return arrange_b(convt_gemm_weight(weight))


def _empty_out(x: torch.Tensor, shape) -> torch.Tensor:
    """An output of the ops' layout for x's dtype: float32 NCHW-contiguous,
    bf16 channels-last."""
    fmt = torch.channels_last if x.dtype == torch.bfloat16 else torch.contiguous_format
    return torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=fmt)


def _launch(kernel, fn, x, wt, scale, shift, cout, out_hw, relu):
    """One float32 kernel launch (NCHW)."""
    b, cin, h, w = x.shape
    x = x.contiguous()
    out = torch.empty((b, cout, *out_hw), dtype=x.dtype, device=x.device)
    kernel.launch(fn, *pointers(x, wt, scale.contiguous(), shift.contiguous(), out),
                  I(b), I(cin), I(cout), I(h), I(w), I(int(relu)))
    return out


def channels_last8(x: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) as the bf16 kernels' TMA reads it: (B, H, W, C8)
    contiguous and 16-byte aligned, C8 = C padded with zero channels to a
    multiple of 8 (an NHWC row pitch that is a multiple of 16 bytes). A
    channels-last x of C % 8 == 0 is taken as it is."""
    nhwc = x.permute(0, 2, 3, 1)
    if x.shape[1] % 8:
        nhwc = F.pad(nhwc, (0, -x.shape[1] % 8))
    if not nhwc.is_contiguous() or nhwc.data_ptr() % 16:
        nhwc = nhwc.clone(memory_format=torch.contiguous_format)
    return nhwc


def launch_bf16(kernel, fn, x8, wt, scale, shift, cout, transposed, relu):
    """One bf16 kernel launch on prepared operands: x8 from
    `channels_last8`, wt from `cached_bf16_operand`. Returns the
    channels-last (B, Cout, Ho, Wo) output."""
    b, h, w, c8 = x8.shape
    out_hw = (2 * h, 2 * w) if transposed else (h, w)
    out = _empty_out(x8, (b, cout, *out_hw))
    kernel.launch(fn, P(x8.data_ptr()), *pointers(wt, scale.contiguous(), shift.contiguous()),
                  P(out.data_ptr()), I(b), I(c8), I(cout), I(h), I(w), I(int(relu)),
                  I(bf16_tile_n(cout, transposed)), I(sm_count(x8.device)))
    return out


def conv3x3_affine_relu(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """relu(conv3x3_same(x, weight) * scale + shift).

    Args:
      x (B, Cin, H, W) float32 or bf16; weight (Cout, Cin, 3, 3), scale,
      shift (Cout,) float32.
    Returns: (B, Cout, H, W) in x's dtype (float32 NCHW-contiguous, bf16
    channels-last).
    """
    _check(x, weight, scale, shift, cin_dim=1)
    return torch.ops.hfr.conv3x3_affine_relu(x, weight, scale, shift, relu)


@torch.library.custom_op("hfr::conv3x3_affine_relu", mutates_args=(), device_types="cpu")
def _conv_op(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             relu: bool) -> torch.Tensor:
    return conv3x3_affine_relu_plain(x, weight, scale, shift, relu)


@_conv_op.register_kernel("cuda")
def _conv_cuda(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               relu: bool) -> torch.Tensor:
    one_device(x, weight, scale, shift)
    cout = _check(x, weight, scale, shift, cin_dim=1)
    if x.dtype == torch.bfloat16:
        return launch_bf16(CONV_BF16_KERNEL, "hfr_conv3x3_bf16", channels_last8(x),
                           cached_bf16_operand(weight, False), scale, shift, cout, False, relu)
    return _launch(CONV_KERNEL, "hfr_conv3x3", x, conv_weight_operand(weight), scale, shift,
                   cout, x.shape[2:], relu)


@_conv_op.register_fake
def _conv_fake(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               relu: bool) -> torch.Tensor:
    one_device(x, weight, scale, shift)
    return _empty_out(x, (x.shape[0], weight.shape[0], *x.shape[2:]))


def _bf16_operands(x, weight):
    """bf16 activations widened to float32 and the weight rounded to bf16
    and widened: the products of the bf16 forms, summed in float32
    (`preferred_element_type=f32`)."""
    return x.float(), weight.to(torch.bfloat16).float()


def _plain_out(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The plain versions' result in x's dtype and the ops' layout."""
    y = y.to(dtype)
    return _empty_out(y, y.shape).copy_(y)


def conv3x3_affine_relu_plain(x, weight, scale, shift, relu: bool = True):
    """In x's dtype: float32, or bf16 rounded where the bf16 kernel rounds.
    The same sums whatever x's memory format (NCHW-contiguous first)."""
    dtype = x.dtype
    x = x.contiguous()
    if dtype == torch.bfloat16:
        x, weight = _bf16_operands(x, weight)
    y = F.conv2d(x, weight, padding=1) * scale[:, None, None] + shift[:, None, None]
    return _plain_out(F.relu(y) if relu else y, dtype)


def convtranspose3x3_affine_relu(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                                 shift: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """relu(convtranspose3x3_stride2_same(x, weight) * scale + shift).

    Args:
      x (B, Cin, H, W) float32 or bf16; weight (Cin, Cout, 3, 3), the
      `nn.ConvTranspose2d` weight of `layers.ConvTransposeBNRelu`; scale,
      shift (Cout,) float32.
    Returns: (B, Cout, 2H, 2W) in x's dtype (float32 NCHW-contiguous,
    bf16 channels-last).
    """
    _check(x, weight, scale, shift, cin_dim=0)
    return torch.ops.hfr.convtranspose3x3_affine_relu(x, weight, scale, shift, relu)


@torch.library.custom_op("hfr::convtranspose3x3_affine_relu", mutates_args=(),
                         device_types="cpu")
def _convt_op(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
              relu: bool) -> torch.Tensor:
    return convtranspose3x3_affine_relu_plain(x, weight, scale, shift, relu)


@_convt_op.register_kernel("cuda")
def _convt_cuda(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                relu: bool) -> torch.Tensor:
    one_device(x, weight, scale, shift)
    cout = _check(x, weight, scale, shift, cin_dim=0)
    h, w = x.shape[2:]
    if x.dtype == torch.bfloat16:
        return launch_bf16(CONVT_BF16_KERNEL, "hfr_convt3x3_bf16", channels_last8(x),
                           cached_bf16_operand(weight, True), scale, shift, cout, True, relu)
    return _launch(CONVT_KERNEL, "hfr_convt3x3", x, convt_weight_operand(weight), scale, shift,
                   cout, (2 * h, 2 * w), relu)


@_convt_op.register_fake
def _convt_fake(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                relu: bool) -> torch.Tensor:
    one_device(x, weight, scale, shift)
    return _empty_out(x, (x.shape[0], weight.shape[1], 2 * x.shape[2], 2 * x.shape[3]))


def convtranspose3x3_affine_relu_plain(x, weight, scale, shift, relu: bool = True):
    """The transposed conv as `layers.ConvTransposeBNRelu` runs it (padding
    0, output 2H + 1, last row and column cropped), then the affine; in
    x's dtype as `conv3x3_affine_relu_plain`."""
    dtype = x.dtype
    x = x.contiguous()
    if dtype == torch.bfloat16:
        x, weight = _bf16_operands(x, weight)
    h, w = x.shape[2:]
    y = F.conv_transpose2d(x, weight, stride=2)[:, :, : 2 * h, : 2 * w]
    y = y * scale[:, None, None] + shift[:, None, None]
    return _plain_out(F.relu(y) if relu else y, dtype)
