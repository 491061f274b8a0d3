"""Seeded weights for a model's state dict, made on its device.

Every tensor is drawn by its name and shape from one uniform draw of a
generator on the device, seeded from the run's seed, in a few large calls:

  - a kernel (a matrix or a 4-D convolution, a (K, C, M) depthwise
    kernel) from a glorot normal truncated at 2 sigma, its fans read from
    the shape (`fans`);
  - a bias: 0.01 N(0, 1), truncated alike;
  - a BatchNorm (a prefix that has a `running_mean`): scale U(0.5, 1.5),
    shift 0.1 N(0, 1), running mean 0.1 N(0, 1), running variance
    U(0.5, 2.0), so that no folded shift is 0 and no scale is 1;
  - a counter (`num_batches_tracked`) is left as it is.

The same seed gives the same state dict, which is loaded into the program
and into the reference alike.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# A 2-sigma truncated normal has this standard deviation.
TRUNC2_STD = 0.87962566103423978


def fans(name: str, shape: Tuple[int, ...]) -> Tuple[int, int]:
    """(fan_in, fan_out) of a kernel: (out, in) matrices, (out, in, kh, kw)
    and (in, out, kh, kw) convolutions (the glorot std is the same for
    both orders), (K, C, M) depthwise kernels (`depthwise` in the name)."""
    if len(shape) == 2:
        return shape[1], shape[0]
    if len(shape) == 4:
        rf = shape[2] * shape[3]
        return shape[1] * rf, shape[0] * rf
    if len(shape) == 3 and name.endswith("depthwise"):
        return shape[0] * shape[1], shape[0] * shape[2]
    raise ValueError(f"no fans for {name} of shape {shape}")


def _uniform_to_trunc_normal(u: torch.Tensor) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2] from uniforms in [0, 1), by the
    inverse CDF (torch's trunc_normal_ does the same)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    z = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * math.sqrt(2.0)
    return z.clamp(-2.0, 2.0)


def seeded_state(template: Dict[str, torch.Tensor], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """A state dict with `template`'s names, shapes and dtypes, drawn on
    `device` from `seed`."""
    bn_prefixes = {k[: -len("running_mean")] for k in template if k.endswith("running_mean")}
    names = sorted(k for k in template if not k.endswith("num_batches_tracked"))
    total = sum(template[k].numel() for k in names)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    z = _uniform_to_trunc_normal(u)
    out, offset = {}, 0
    for k in names:
        shape = tuple(template[k].shape)
        n = template[k].numel()
        uk, zk = u[offset:offset + n].view(shape), z[offset:offset + n].view(shape)
        offset += n
        prefix, leaf = k.rsplit(".", 1) if "." in k else ("", k)
        if prefix + "." in bn_prefixes or (prefix == "" and "" in bn_prefixes):
            t = {"weight": 0.5 + uk, "bias": 0.1 * zk, "running_mean": 0.1 * zk,
                 "running_var": 0.5 + 1.5 * uk}[leaf]
        elif leaf == "bias" or len(shape) == 1:
            t = 0.01 * zk
        else:
            fan_in, fan_out = fans(k, shape)
            t = zk * (math.sqrt(2.0 / (fan_in + fan_out)) / TRUNC2_STD)
        out[k] = t.to(template[k].dtype)
    for k in template:
        if k.endswith("num_batches_tracked"):
            out[k] = template[k].detach().clone().to(device)
    return out
