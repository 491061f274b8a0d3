"""Shared NN building blocks (PyTorch port of
heterofusionrcnn_tpu/models/extractors/layers.py).

Submodule and parameter names follow the flax param tree (`Dense_0`,
`BatchNorm_0`, `depthwise`, ...) so `heterofusionrcnn_torch.convert` maps
checkpoints by path. The pointfly convention is linear -> activation ->
BatchNorm, BN with flax momentum 0.99 (torch 0.01) and epsilon 1e-3. In
training the BatchNorms follow flax, not torch: they normalise with the
biased batch variance and move their running statistics with it (torch
would use the unbiased one there), and dropout draws its mask from a
generator the caller passes.
Point layers work on channels-last (..., C) tensors; the image layers on
NCHW, their callers convert from the NHWC of the public API. With
`conv_kernel=True` the image layers run, in eval mode, as one fused
conv + folded-BN + ReLU call (`ops/conv.py`), the port's counterpart of the
JAX package's `HFR_PALLAS_CONV=1`; off, they run the cuDNN / CPU conv and
BatchNorm, the JAX package's default path.

`dtype` is the compute dtype of the flax modules' `dtype=` (None: float32;
`torch.bfloat16` for mixed precision, in training and inference).
Parameters and buffers stay float32, so one float32 checkpoint serves and
trains in either dtype: a Dense or conv casts its input, kernel and bias
to `dtype`, takes the product in `dtype` (float32 sums) and adds the bias
in `dtype`, and autograd returns float32 gradients through each cast to
the float32 parameters (the transpose of JAX's cast); a BatchNorm
normalises a bf16 input in float32 (its batch statistics, or its running
ones in inference, are float32) and rounds the result to bf16 once (flax
`_compute_stats` and `_normalize`); dropout keeps the input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from heterofusionrcnn_torch.ops.conv import conv3x3_affine_relu, convtranspose3x3_affine_relu
from heterofusionrcnn_torch.parallel.mesh import all_reduce_sum

BN_EPS = 1e-3
BN_MOMENTUM = 0.01


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax `nn.Dense(dtype=...)`: the product in `dtype` (float32 sums),
    then the bias added in `dtype`; dtype None is the float32 `F.linear`."""
    if dtype is None:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def elu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.elu`: `F.elu` in float32; in a reduced precision (bf16) the
    JAX function's own form where(x > 0, x, expm1(where(x > 0, 0, x))), so
    that its backward rounds as JAX's does (the cotangent times
    expm1(x) + 1, each rounded to x's dtype) where `F.elu`'s rounds once."""
    if x.dtype == torch.float32:
        return F.elu(x)
    pos = x > 0
    return torch.where(pos, x, torch.expm1(torch.where(pos, torch.zeros_like(x), x)))


def batch_norm_eval_promoted(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                             channel_dim: int) -> torch.Tensor:
    """flax `nn.BatchNorm` in inference on a reduced-precision `x`:
    (x - mean) with the float32 mean is float32, so the normalisation runs
    in float32 and its result is rounded to x's dtype once."""
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = (x.float() - bn.running_mean.reshape(shape)) * mul.reshape(shape) + bn.bias.reshape(shape)
    return y.to(x.dtype)


def batch_norm_train(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                     channel_dim: int,
                     group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """flax `nn.BatchNorm` in training: normalise by the batch mean and the
    biased batch variance E[x^2] - E[x]^2 (clamped at 0, flax's fast
    variance) over every dimension but `channel_dim`, and move the running
    statistics to (1 - momentum) * running + momentum * batch.

    A reduced-precision `x` (bf16) is widened to float32 for all of it, as
    flax's `force_float32_reductions`: the statistics, x - mean and the
    affine are float32, the running statistics move in float32, and the
    result is rounded to x's dtype once. As in flax, the statistics and the
    normalisation widen x apart, so the backward rounds each path's
    gradient to x's dtype before adding them. flax keeps the fast
    variance's cancellation for channels of a large mean, and so does this.

    With a data-parallel `group` the batch is the global one: the mean and
    E[x^2] come from the float32 sums of x and x^2 all-reduced over the
    group (one all-reduce, differentiable, `parallel/mesh.py`) over the
    global count of elements, so every rank normalises and moves its
    running statistics alike."""
    dims = [d for d in range(x.dim()) if d != channel_dim % x.dim()]
    shape = [1] * x.dim()
    shape[channel_dim] = x.shape[channel_dim]
    xs = x.float()
    if group is None:
        mean = xs.mean(dims)
        mean_sq = (xs * xs).mean(dims)
    else:
        c = x.shape[channel_dim]
        sums = all_reduce_sum(torch.cat([xs.sum(dims), (xs * xs).sum(dims)]), group)
        count = (x.numel() // c) * dist.get_world_size(group)
        mean, mean_sq = sums[:c] / count, sums[c:] / count
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(bn.momentum * mean)
        bn.running_var.mul_(1.0 - bn.momentum).add_(bn.momentum * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x.float() - mean.reshape(shape)) * mul.reshape(shape) + bn.bias.reshape(shape)
    return y.to(x.dtype)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last dimension of a (..., C) tensor; `dp_group`:
    the data-parallel group whose global batch it normalises over in
    training (None: this process's batch)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.dp_group: Optional[dist.ProcessGroup] = None

    def forward(self, x):
        if self.training:
            return batch_norm_train(self, x, -1, self.dp_group)
        if x.dtype != torch.float32:
            return batch_norm_eval_promoted(self, x, -1)
        shape = x.shape
        return super().forward(x.reshape(-1, shape[-1])).reshape(shape)

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Inference affine (s, t) with BN(x) = x * s + t."""
        s = self.weight / torch.sqrt(self.running_var + self.eps)
        return s, self.bias - self.running_mean * s


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over the channels of an NCHW tensor (`dp_group` as
    `BatchNorm`'s)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.dp_group: Optional[dist.ProcessGroup] = None

    def forward(self, x):
        if self.training:
            return batch_norm_train(self, x, 1, self.dp_group)
        if x.dtype != torch.float32:
            return batch_norm_eval_promoted(self, x, 1)
        return super().forward(x)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """flax `nn.Dropout` in training: keep each element with probability
    1 - rate (a uniform draw from `generator` below it) and scale the kept
    ones by 1 / (1 - rate).

    With a data-parallel `group` the draw is the global batch's (leading
    axis x world size) and this rank keeps its rows of it, so its mask is
    its rows of a one-process mask and every rank's generator advances
    alike. The scaling runs in x's dtype as flax's `inputs / keep_prob`
    does: a Python float meets a JAX array as a weak type, rounded to the
    array's dtype, so a bf16 input is divided by 1 - rate rounded to bf16
    and stays bf16."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a generator")
    keep = 1.0 - rate
    scale = float(torch.tensor(keep, dtype=x.dtype))
    if group is None:
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    else:
        rank, b = dist.get_rank(group), x.shape[0]
        shape = (b * dist.get_world_size(group), *x.shape[1:])
        draw = torch.rand(shape, generator=generator, device=x.device)
        mask = draw[rank * b:(rank + 1) * b] < keep
    return torch.where(mask, x / scale, torch.zeros_like(x))


class DenseBN(nn.Module):
    """Dense -> ELU -> BN (pointfly.dense); without BN the Dense has a bias."""

    def __init__(self, in_features: int, features: int, use_bn: bool = True,
                 activation: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features, bias=not use_bn)
        self.activation = activation
        self.BatchNorm_0 = BatchNorm(features) if use_bn else None
        self.dtype = dtype

    def forward(self, x):
        x = linear(x, self.Dense_0.weight, self.Dense_0.bias, self.dtype)
        if self.activation:
            x = elu(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return x


class ConvOverK(nn.Module):
    """(1, K) VALID conv as a Dense over the flattened (K, C) neighbourhood:
    (B, P, K, C) -> (B, P, features)."""

    def __init__(self, k: int, in_channels: int, features: int, use_bn=True,
                 activation=True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.DenseBN_0 = DenseBN(k * in_channels, features, use_bn, activation, dtype)

    def forward(self, x):
        b, p, k, c = x.shape
        return self.DenseBN_0(x.reshape(b, p, k * c))


class DepthwiseConvOverK(nn.Module):
    """(1, K) depthwise conv with a depth multiplier:
    (B, P, K, C) -> (B, P, C * depth_multiplier)."""

    def __init__(self, k: int, in_channels: int, depth_multiplier: int,
                 use_bn=True, activation=True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.depthwise = nn.Parameter(torch.empty(k, in_channels, depth_multiplier))
        self.activation = activation
        self.BatchNorm_0 = BatchNorm(in_channels * depth_multiplier) if use_bn else None
        self.dtype = dtype

    def forward(self, x):
        b, p, k, c = x.shape
        w = self.depthwise
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
        out = torch.einsum("bpkc,kcj->bpcj", x, w).reshape(b, p, -1)
        if self.activation:
            out = elu(out)
        if self.BatchNorm_0 is not None:
            out = self.BatchNorm_0(out)
        return out


class SeparableConvOverK(nn.Module):
    """(1, K) separable conv (depthwise then pointwise, no nonlinearity in
    between), ELU + BN at the end: (B, P, K, C) -> (B, P, features). The
    two weights compose into one (K, C, features) kernel."""

    def __init__(self, k: int, in_channels: int, features: int,
                 depth_multiplier: int = 1, use_bn=True, activation=True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.depth_multiplier = depth_multiplier
        self.depthwise = nn.Parameter(torch.empty(k, in_channels, depth_multiplier))
        self.Dense_0 = nn.Linear(in_channels * depth_multiplier, features, bias=not use_bn)
        self.activation = activation
        self.BatchNorm_0 = BatchNorm(features) if use_bn else None

    def composed_weight(self) -> torch.Tensor:
        k, c, dm = self.depthwise.shape
        wp = self.Dense_0.weight.t().reshape(c, dm, -1)
        return torch.einsum("kcj,cjd->kcd", self.depthwise, wp)

    def forward(self, x):
        """The weights composed in float32, then cast to `dtype` with x."""
        b, p, k, c = x.shape
        w, bias = self.composed_weight().reshape(k * c, -1), self.Dense_0.bias
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
            bias = None if bias is None else bias.to(self.dtype)
        out = x.reshape(b, p, k * c) @ w
        if bias is not None:
            out = out + bias
        if self.activation:
            out = elu(out)
        if self.BatchNorm_0 is not None:
            out = self.BatchNorm_0(out)
        return out


def fold_bn_affine(conv: nn.Module, bn: BatchNorm2d):
    """Inference BatchNorm (epsilon 1e-3) and the conv bias folded into a
    per-channel (scale, shift): bn(conv(x)) = conv_nobias(x) * scale + shift
    (the JAX package's `layers._fold_bn_affine`)."""
    s = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    t = bn.bias - bn.running_mean * s
    if conv.bias is not None:
        t = t + conv.bias * s
    return s, t


class ConvBNRelu(nn.Module):
    """3x3 SAME conv (with bias) + BN + ReLU on NCHW."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 conv_kernel: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel, padding=kernel // 2)
        self.BatchNorm_0 = BatchNorm2d(features)
        self.conv_kernel = conv_kernel and kernel == 3
        self.dtype = dtype

    def forward(self, x):
        """In `dtype` the fused op takes x rounded to it (the kernel's
        entry follows x's dtype); the unfused conv casts x, kernel and
        bias, as flax's `nn.Conv(dtype=...)`."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.conv_kernel and not self.training:
            s, t = fold_bn_affine(self.Conv_0, self.BatchNorm_0)
            return conv3x3_affine_relu(x, self.Conv_0.weight, s, t)
        if self.dtype is None:
            y = self.Conv_0(x)
        else:
            conv = self.Conv_0
            y = F.conv2d(x, conv.weight.to(self.dtype), padding=conv.padding)
            y = y + conv.bias.to(self.dtype)[:, None, None]
        return F.relu(self.BatchNorm_0(y))


class ConvTransposeBNRelu(nn.Module):
    """3x3 stride-2 SAME transposed conv (with bias) + BN + ReLU on NCHW,
    output (2H, 2W).

    Flax's SAME stride-2 ConvTranspose sends x[m] to y[2m + t] through tap
    w[2 - t]; torch's transposed conv sends it to y[2m - pad + t] through
    w[t]. So `ConvTranspose_0` holds the flax kernel flipped in both spatial
    axes (the converter flips it), runs with padding 0 (output 2H + 1) and
    the last row and column are cropped."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 conv_kernel: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(in_channels, features, kernel, stride=2)
        self.BatchNorm_0 = BatchNorm2d(features)
        self.conv_kernel = conv_kernel and kernel == 3
        self.dtype = dtype

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.conv_kernel and not self.training:
            s, t = fold_bn_affine(self.ConvTranspose_0, self.BatchNorm_0)
            return convtranspose3x3_affine_relu(x, self.ConvTranspose_0.weight, s, t)
        h, w = x.shape[2], x.shape[3]
        if self.dtype is None:
            y = self.ConvTranspose_0(x)
        else:
            convt = self.ConvTranspose_0
            y = F.conv_transpose2d(x, convt.weight.to(self.dtype), stride=2)
            y = y + convt.bias.to(self.dtype)[:, None, None]
        return F.relu(self.BatchNorm_0(y[:, :, : 2 * h, : 2 * w]))


def glorot_normal_(t: torch.Tensor, fan_in: int, fan_out: int, gen: torch.Generator):
    """Truncated (2 sigma) glorot normal, flax's default kernel init."""
    std = math.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978
    with torch.no_grad():
        t.copy_(
            torch.nn.init.trunc_normal_(
                torch.empty(t.shape), std=std, a=-2 * std, b=2 * std, generator=gen
            )
        )


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Random weights from `seed`, on the CPU then moved: glorot kernels,
    zero biases, BN scale 1 / shift 0, running mean 0 / var 1."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.Linear):
            glorot_normal_(m.weight, m.in_features, m.out_features, gen)
        elif isinstance(m, nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            glorot_normal_(m.weight, i * kh * kw, o * kh * kw, gen)
        elif isinstance(m, nn.ConvTranspose2d):
            i, o, kh, kw = m.weight.shape
            glorot_normal_(m.weight, i * kh * kw, o * kh * kw, gen)
        elif isinstance(m, (DepthwiseConvOverK, SeparableConvOverK)):
            k, c, dm = m.depthwise.shape
            glorot_normal_(m.depthwise, k * c, k * dm, gen)
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)) and m.bias is not None:
            nn.init.zeros_(m.bias)
        if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.reset_running_stats()
    return module
