"""Flax variables -> PyTorch state_dict.

The port's modules carry the flax module names, so a flax leaf at
`a/b/Dense_0/kernel` becomes `a.b.Dense_0.weight`. Per leaf:
  Dense kernel (in, out)            -> Linear weight (out, in)
  Conv kernel HWIO                  -> Conv2d weight OIHW
  ConvTranspose kernel HWIO         -> ConvTranspose2d weight (I, O, H, W),
                                       flipped in H and W (see
                                       layers.ConvTransposeBNRelu)
  BatchNorm scale / bias            -> weight / bias
  batch_stats mean / var            -> running_mean / running_var
  depthwise (K, C, dm), biases      -> unchanged
Flax BatchNorm momentum 0.99 / epsilon 1e-3 is torch momentum 0.01 /
eps 1e-3, set by the modules themselves. Inputs are nested dicts of numpy
(or numpy-convertible) arrays: nothing here imports jax.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def flax_to_state_dict(params: Mapping, batch_stats: Mapping = None) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, leaf in _leaves(params):
        parent, name = (path[-2] if len(path) > 1 else ""), path[-1]
        arr = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            if parent == "Conv_0":
                arr = arr.transpose(3, 2, 0, 1)
            elif parent == "ConvTranspose_0":
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                arr = arr.T
            torch_name = "weight"
        elif name == "scale":
            torch_name = "weight"
        elif name in ("bias", "depthwise"):
            torch_name = name
        else:
            raise KeyError(f"unknown flax leaf {'/'.join(path)}")
        sd[".".join(path[:-1] + (torch_name,))] = torch.from_numpy(np.array(arr))
    renames = {"mean": "running_mean", "var": "running_var"}
    for path, leaf in _leaves(batch_stats or {}):
        key = ".".join(path[:-1] + (renames[path[-1]],))
        sd[key] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return sd


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load flax `{"params", "batch_stats"}` into `module` in place. Every
    parameter and buffer of the module must be covered, and every flax leaf
    must land (BatchNorm step counters excepted)."""
    sd = flax_to_state_dict(variables["params"], variables.get("batch_stats"))
    result = module.load_state_dict(sd, strict=False)
    missing = [k for k in result.missing_keys if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"missing {missing}, unexpected {result.unexpected_keys}")
    return module
