"""`torch.library.opcheck` of the op `hfr::crop_gather` on the CPU, in
float32 and bf16 with each pair of int32 / int64 index dtypes.

The crop kernel (`csrc/crop.cu`) computes its own layout and runs only on
the card; `tests/test_torch_cuda.py` holds it against the plain gather bit
for bit, with exactly one launch a call.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from heterofusionrcnn_torch.ops.cropping import crop_gather_plain


def _op_args(dtype, idx_dtype, box_dtype):
    rng = np.random.default_rng(31)
    src = torch.from_numpy(rng.standard_normal((2, 40, 16)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 40, (6, 12))).to(idx_dtype)
    box_ind = torch.tensor([0, 0, 1, 1, 0, 1], dtype=box_dtype)
    return src, idx, box_ind


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("idx_dtype,box_dtype", [(torch.int32, torch.int32),
                                                 (torch.int32, torch.int64),
                                                 (torch.int64, torch.int32),
                                                 (torch.int64, torch.int64)],
                         ids=["i32-i32", "i32-i64", "i64-i32", "i64-i64"])
def test_opcheck_crop_gather(dtype, idx_dtype, box_dtype):
    """opcheck of hfr::crop_gather on the CPU (schema, fake function against
    the CPU implementation, registration), with each pair of index dtypes
    the CUDA implementation takes without a cast."""
    args = _op_args(dtype, idx_dtype, box_dtype)
    torch.library.opcheck(torch.ops.hfr.crop_gather.default, args)
    got = torch.ops.hfr.crop_gather(*args)
    assert got.dtype == dtype and torch.equal(got, crop_gather_plain(*args))
