"""Fused 3x3 convolutions of the VGG image branch: conv (or stride-2
transposed conv) + folded BatchNorm affine + ReLU, NCHW float32.

Port of heterofusionrcnn_tpu/ops/pallas_conv.py `conv3x3_affine_relu` and
heterofusionrcnn_tpu/ops/pallas_convtranspose.py
`convtranspose3x3_affine_relu`, in the port's layouts: activations NCHW,
the conv weight (Cout, Cin, 3, 3) and the transposed conv weight
(Cin, Cout, 3, 3) as `nn.Conv2d` / `nn.ConvTranspose2d` hold them (the
latter flipped in both spatial axes against flax, see
`layers.ConvTransposeBNRelu`). CUDA tensors launch the kernels of
`csrc/conv.cu` and `csrc/convt.cu`; CPU tensors run the plain versions.
Any H and W are taken; the TPU's tile-fit gate has no counterpart.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from heterofusionrcnn_torch.ops.dispatch import I, P, CudaKernel, pointers, use_kernel

_ARGS = [P, P, P, P, P, I, I, I, I, I, I]
CONV_KERNEL = CudaKernel("conv.cu", {"hfr_conv3x3": _ARGS}, exact=False)
CONVT_KERNEL = CudaKernel("convt.cu", {"hfr_convt3x3": _ARGS}, exact=False)


def _check(x, weight, scale, shift, cin_dim: int):
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"need x (B, C, H, W) and a 3x3 weight, got {tuple(x.shape)} "
                         f"and {tuple(weight.shape)}")
    if weight.shape[cin_dim] != x.shape[1]:
        raise ValueError(f"weight {tuple(weight.shape)} does not take {x.shape[1]} channels")
    cout = weight.shape[1 - cin_dim]
    if scale.shape != (cout,) or shift.shape != (cout,):
        raise ValueError(f"scale/shift must be ({cout},)")
    if any(t.dtype != torch.float32 for t in (x, weight, scale, shift)):
        raise ValueError("conv kernels take float32")
    if x.numel() >= 2**31:
        raise ValueError("conv kernels take fewer than 2**31 input elements")
    return cout


def _launch(kernel, fn, x, wt, scale, shift, cout, out_hw, relu):
    b, cin, h, w = x.shape
    x = x.contiguous()
    out = torch.empty((b, cout, *out_hw), dtype=torch.float32, device=x.device)
    kernel.launch(fn, *pointers(x, wt, scale.contiguous(), shift.contiguous(), out),
                  I(b), I(cin), I(cout), I(h), I(w), I(int(relu)))
    return out


def conv3x3_affine_relu(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """relu(conv3x3_same(x, weight) * scale + shift).

    Args:
      x (B, Cin, H, W); weight (Cout, Cin, 3, 3); scale, shift (Cout,).
    Returns: (B, Cout, H, W).
    """
    cout = _check(x, weight, scale, shift, cin_dim=1)
    if not use_kernel(x, weight, scale, shift):
        return conv3x3_affine_relu_plain(x, weight, scale, shift, relu)
    wt = weight.permute(1, 2, 3, 0).contiguous()  # (Cin, 3, 3, Cout)
    return _launch(CONV_KERNEL, "hfr_conv3x3", x, wt, scale, shift, cout,
                   x.shape[2:], relu)


def conv3x3_affine_relu_plain(x, weight, scale, shift, relu: bool = True):
    y = F.conv2d(x, weight, padding=1) * scale[:, None, None] + shift[:, None, None]
    return F.relu(y) if relu else y


def convtranspose3x3_affine_relu(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                                 shift: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """relu(convtranspose3x3_stride2_same(x, weight) * scale + shift).

    Args:
      x (B, Cin, H, W); weight (Cin, Cout, 3, 3), the `nn.ConvTranspose2d`
      weight of `layers.ConvTransposeBNRelu`; scale, shift (Cout,).
    Returns: (B, Cout, 2H, 2W).
    """
    cout = _check(x, weight, scale, shift, cin_dim=0)
    if not use_kernel(x, weight, scale, shift):
        return convtranspose3x3_affine_relu_plain(x, weight, scale, shift, relu)
    wt = weight.permute(0, 2, 3, 1).contiguous()  # (Cin, 3, 3, Cout)
    h, w = x.shape[2:]
    return _launch(CONVT_KERNEL, "hfr_convt3x3", x, wt, scale, shift, cout,
                   (2 * h, 2 * w), relu)


def convtranspose3x3_affine_relu_plain(x, weight, scale, shift, relu: bool = True):
    """The transposed conv as `layers.ConvTransposeBNRelu` runs it (padding
    0, output 2H + 1, last row and column cropped), then the affine."""
    h, w = x.shape[2:]
    y = F.conv_transpose2d(x, weight, stride=2)[:, :, : 2 * h, : 2 * w]
    y = y * scale[:, None, None] + shift[:, None, None]
    return F.relu(y) if relu else y
