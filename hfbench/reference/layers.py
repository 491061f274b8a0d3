"""The network's building blocks in float32 plain PyTorch.

Submodule and parameter names are those of the port's modules (the flax
tree's: `Dense_0`, `BatchNorm_0`, `depthwise`, ...), so one state dict
loads into both. The pointfly order is linear -> ELU -> BatchNorm; a
BatchNorm has flax's momentum 0.99 (torch 0.01) and epsilon 1e-3, and in
training normalises with the biased batch variance E[x^2] - E[x]^2 and
moves its running statistics with it. Dropout draws its mask from the
generator the caller passes, one uniform draw of the input's shape.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.01


def batch_norm_train(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                     channel_dim: int) -> torch.Tensor:
    """Normalise by the batch mean and biased variance over every dimension
    but `channel_dim` and move the running statistics."""
    shape = [1] * x.dim()
    shape[channel_dim] = x.shape[channel_dim]
    dims = [d for d in range(x.dim()) if d != channel_dim % x.dim()]
    mean, mean_sq = x.mean(dims), (x * x).mean(dims)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(bn.momentum * mean)
        bn.running_var.mul_(1.0 - bn.momentum).add_(bn.momentum * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean.reshape(shape)) * mul.reshape(shape) + bn.bias.reshape(shape)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last dimension of a (..., C) tensor."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        if self.training:
            return batch_norm_train(self, x, -1)
        shape = x.shape
        return super().forward(x.reshape(-1, shape[-1])).reshape(shape)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over the channels of an NCHW tensor."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        if self.training:
            return batch_norm_train(self, x, 1)
        return super().forward(x)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keep each element where a uniform draw is below 1 - rate, scaled by
    1 / (1 - rate)."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a generator")
    keep = 1.0 - rate
    scale = float(torch.tensor(keep, dtype=x.dtype))
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / scale, torch.zeros_like(x))


class DenseBN(nn.Module):
    """Dense -> ELU -> BN; without BN the Dense has a bias."""

    def __init__(self, in_features: int, features: int, use_bn: bool = True,
                 activation: bool = True):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features, bias=not use_bn)
        self.activation = activation
        self.BatchNorm_0 = BatchNorm(features) if use_bn else None

    def forward(self, x):
        x = F.linear(x, self.Dense_0.weight, self.Dense_0.bias)
        if self.activation:
            x = F.elu(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return x


class ConvOverK(nn.Module):
    """(1, K) VALID conv as a Dense over the flattened (K, C) neighbourhood."""

    def __init__(self, k: int, in_channels: int, features: int, use_bn=True, activation=True):
        super().__init__()
        self.DenseBN_0 = DenseBN(k * in_channels, features, use_bn, activation)

    def forward(self, x):
        b, p, k, c = x.shape
        return self.DenseBN_0(x.reshape(b, p, k * c))


class DepthwiseConvOverK(nn.Module):
    """(1, K) depthwise conv with a depth multiplier: (B, P, K, C) ->
    (B, P, C * depth_multiplier)."""

    def __init__(self, k: int, in_channels: int, depth_multiplier: int,
                 use_bn=True, activation=True):
        super().__init__()
        self.depthwise = nn.Parameter(torch.empty(k, in_channels, depth_multiplier))
        self.activation = activation
        self.BatchNorm_0 = BatchNorm(in_channels * depth_multiplier) if use_bn else None

    def forward(self, x):
        b, p, k, c = x.shape
        out = torch.einsum("bpkc,kcj->bpcj", x, self.depthwise).reshape(b, p, -1)
        if self.activation:
            out = F.elu(out)
        if self.BatchNorm_0 is not None:
            out = self.BatchNorm_0(out)
        return out


class SeparableConvOverK(nn.Module):
    """(1, K) separable conv, its depthwise and pointwise weights composed
    into one (K, C, features) kernel, then ELU + BN."""

    def __init__(self, k: int, in_channels: int, features: int,
                 depth_multiplier: int = 1, use_bn=True, activation=True):
        super().__init__()
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
        b, p, k, c = x.shape
        out = x.reshape(b, p, k * c) @ self.composed_weight().reshape(k * c, -1)
        if self.Dense_0.bias is not None:
            out = out + self.Dense_0.bias
        if self.activation:
            out = F.elu(out)
        if self.BatchNorm_0 is not None:
            out = self.BatchNorm_0(out)
        return out


class ConvBNRelu(nn.Module):
    """3x3 SAME conv (with bias) + BN + ReLU on NCHW."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel, padding=kernel // 2)
        self.BatchNorm_0 = BatchNorm2d(features)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class ConvTransposeBNRelu(nn.Module):
    """3x3 stride-2 SAME transposed conv (with bias) + BN + ReLU on NCHW,
    output (2H, 2W): padding 0 gives 2H + 1, whose last row and column are
    cropped (the kernel is flax's flipped in both spatial axes)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(in_channels, features, kernel, stride=2)
        self.BatchNorm_0 = BatchNorm2d(features)

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        y = self.ConvTranspose_0(x)
        return F.relu(self.BatchNorm_0(y[:, :, : 2 * h, : 2 * w]))
