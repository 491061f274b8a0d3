"""Fused 3x3 convolutions of the VGG image branch: conv (or stride-2
transposed conv) + folded BatchNorm affine + ReLU, NCHW, in float32 or in
bf16 (the bf16 serving path).

Port of heterofusionrcnn_tpu/ops/pallas_conv.py `conv3x3_affine_relu` and
heterofusionrcnn_tpu/ops/pallas_convtranspose.py
`convtranspose3x3_affine_relu`, in the port's layouts: activations NCHW,
the conv weight (Cout, Cin, 3, 3) and the transposed conv weight
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
output. The weight stays a float32 parameter; the op rounds and arranges
it per call (`bf16_weight_operand`). Any other dtype raises.

The kernels take the weight as their GEMM's B operand, arranged inside the
op's CUDA implementation once per call from the weight it is given
(`conv_weight_operand`, `convt_weight_operand`): K rows in the kernel's
order (`conv_gemm_weight`, `convt_gemm_weight`), each value split into two
TF32 parts (`split_tf32`), cut into wgmma B tiles (`arrange_b`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from heterofusionrcnn_torch.ops.dispatch import I, P, CudaKernel, one_device, pointers

_ARGS = [P, P, P, P, P, I, I, I, I, I, I]
N_ALIGN = 64  # output channels of the arranged weight padded to this (kNAlign)
BF16_CHUNK = 16  # input channels per k16 step of the bf16 kernels (kKC)
CONV_KERNEL = CudaKernel("conv.cu", {"hfr_conv3x3": _ARGS}, exact=False)
CONVT_KERNEL = CudaKernel("convt.cu", {"hfr_convt3x3": _ARGS}, exact=False)
# The bf16 entries of the same libraries, counted apart.
CONV_BF16_KERNEL = CudaKernel("conv.cu", {"hfr_conv3x3_bf16": _ARGS}, exact=False,
                              name="conv_bf16")
CONVT_BF16_KERNEL = CudaKernel("convt.cu", {"hfr_convt3x3_bf16": _ARGS}, exact=False,
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


def bf16_weight_operand(w9: torch.Tensor) -> torch.Tensor:
    """What the bf16 kernels (`csrc/conv_bf16.cuh`) take for a (Cout, Cin,
    9 taps) weight: (Cin / 16, 9, Cout padded to N_ALIGN, 16) bf16, i.e.
    [chunk of 16 input channels][tap][output channel][channel in chunk],
    zeros in the padding."""
    cout, cin, _ = w9.shape
    cp = -(-cin // BF16_CHUNK) * BF16_CHUNK
    w = F.pad(w9, (0, 0, 0, cp - cin, 0, _n_padded(cout) - cout))
    w = w.reshape(-1, cp // BF16_CHUNK, BF16_CHUNK, 9).permute(1, 3, 0, 2)
    return w.to(torch.bfloat16).contiguous()


def conv_weight_operand(weight: torch.Tensor) -> torch.Tensor:
    """What `csrc/conv.cu` takes for the (Cout, Cin, 3, 3) weight."""
    return arrange_b(conv_gemm_weight(weight))


def convt_weight_operand(weight: torch.Tensor) -> torch.Tensor:
    """What `csrc/convt.cu` takes for the (Cin, Cout, 3, 3) weight."""
    return arrange_b(convt_gemm_weight(weight))


def _launch(kernel, fn, x, wt, scale, shift, cout, out_hw, relu):
    b, cin, h, w = x.shape
    x = x.contiguous()
    out = torch.empty((b, cout, *out_hw), dtype=x.dtype, device=x.device)
    kernel.launch(fn, *pointers(x, wt, scale.contiguous(), shift.contiguous(), out),
                  I(b), I(cin), I(cout), I(h), I(w), I(int(relu)))
    return out


def conv3x3_affine_relu(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """relu(conv3x3_same(x, weight) * scale + shift).

    Args:
      x (B, Cin, H, W) float32 or bf16; weight (Cout, Cin, 3, 3), scale,
      shift (Cout,) float32.
    Returns: (B, Cout, H, W) in x's dtype.
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
        wt = bf16_weight_operand(weight.reshape(cout, x.shape[1], 9))
        return _launch(CONV_BF16_KERNEL, "hfr_conv3x3_bf16", x, wt, scale, shift, cout,
                       x.shape[2:], relu)
    return _launch(CONV_KERNEL, "hfr_conv3x3", x, conv_weight_operand(weight), scale, shift,
                   cout, x.shape[2:], relu)


@_conv_op.register_fake
def _conv_fake(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               relu: bool) -> torch.Tensor:
    one_device(x, weight, scale, shift)
    return x.new_empty((x.shape[0], weight.shape[0], *x.shape[2:]))


def _bf16_operands(x, weight):
    """bf16 activations widened to float32 and the weight rounded to bf16
    and widened: the products of the bf16 forms, summed in float32
    (`preferred_element_type=f32`)."""
    return x.float(), weight.to(torch.bfloat16).float()


def conv3x3_affine_relu_plain(x, weight, scale, shift, relu: bool = True):
    """In x's dtype: float32, or bf16 rounded where the bf16 kernel rounds."""
    dtype = x.dtype
    if dtype == torch.bfloat16:
        x, weight = _bf16_operands(x, weight)
    y = F.conv2d(x, weight, padding=1) * scale[:, None, None] + shift[:, None, None]
    return (F.relu(y) if relu else y).to(dtype)


def convtranspose3x3_affine_relu(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                                 shift: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """relu(convtranspose3x3_stride2_same(x, weight) * scale + shift).

    Args:
      x (B, Cin, H, W) float32 or bf16; weight (Cin, Cout, 3, 3), the
      `nn.ConvTranspose2d` weight of `layers.ConvTransposeBNRelu`; scale,
      shift (Cout,) float32.
    Returns: (B, Cout, 2H, 2W) in x's dtype.
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
        wt = bf16_weight_operand(weight.reshape(x.shape[1], cout, 9).permute(1, 0, 2))
        return _launch(CONVT_BF16_KERNEL, "hfr_convt3x3_bf16", x, wt, scale, shift, cout,
                       (2 * h, 2 * w), relu)
    return _launch(CONVT_KERNEL, "hfr_convt3x3", x, convt_weight_operand(weight), scale, shift,
                   cout, (2 * h, 2 * w), relu)


@_convt_op.register_fake
def _convt_fake(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                relu: bool) -> torch.Tensor:
    one_device(x, weight, scale, shift)
    return x.new_empty((x.shape[0], weight.shape[1], 2 * x.shape[2], 2 * x.shape[3]))


def convtranspose3x3_affine_relu_plain(x, weight, scale, shift, relu: bool = True):
    """The transposed conv as `layers.ConvTransposeBNRelu` runs it (padding
    0, output 2H + 1, last row and column cropped), then the affine; in
    x's dtype as `conv3x3_affine_relu_plain`."""
    dtype = x.dtype
    if dtype == torch.bfloat16:
        x, weight = _bf16_operands(x, weight)
    h, w = x.shape[2:]
    y = F.conv_transpose2d(x, weight, stride=2)[:, :, : 2 * h, : 2 * w]
    y = y * scale[:, None, None] + shift[:, None, None]
    return (F.relu(y) if relu else y).to(dtype)
