"""The fused conv ops' layouts and the bf16 kernels' weight operand, on the CPU.

`hfr::conv3x3_affine_relu` and `hfr::convtranspose3x3_affine_relu` promise
one output layout per dtype in all three implementations (the CUDA kernel,
the CPU plain version, the fake that `torch.export` traces through):
float32 NCHW-contiguous, bf16 channels-last, whatever the input's memory
format. `torch.library.opcheck` holds the CPU implementation and the fake
to the same strides. The bf16 kernels take the weight arranged by
`bf16_weight_operand`, cached once per weight version
(`cached_bf16_operand`), and the input padded to 8 channels
(`channels_last8`); those are plain functions on tensors, checked here
against explicit index formulas.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from heterofusionrcnn_torch.ops import conv

OPS = {"conv": torch.ops.hfr.conv3x3_affine_relu.default,
       "convt": torch.ops.hfr.convtranspose3x3_affine_relu.default}


def _case(rng, transpose, b, cin, cout, h, w, dtype, channels_last):
    x = torch.from_numpy(rng.standard_normal((b, cin, h, w)).astype(np.float32)).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    wshape = (cin, cout, 3, 3) if transpose else (cout, cin, 3, 3)
    wt = torch.from_numpy((rng.standard_normal(wshape) / np.sqrt(9 * cin)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32))
    shift = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32))
    return x, wt, scale, shift


@pytest.mark.parametrize("cin,cout", [(3, 8), (16, 20)])
@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["conv", "convt"])
def test_opcheck_and_output_layout(name, dtype, channels_last, cin, cout):
    """opcheck (schema, fake against the CPU implementation, strides
    included) passes, and the output is float32 NCHW-contiguous or bf16
    channels-last, for NCHW and channels-last inputs."""
    args = _case(np.random.default_rng(0), name == "convt", 2, cin, cout, 5, 7, dtype,
                 channels_last)
    op = OPS[name]
    torch.library.opcheck(op, (*args, True))
    out = op(*args, True)
    fmt = torch.channels_last if dtype == torch.bfloat16 else torch.contiguous_format
    assert out.dtype == dtype and out.is_contiguous(memory_format=fmt)
    h, w = (10, 14) if name == "convt" else (5, 7)
    assert out.stride() == torch.empty((2, cout, h, w), memory_format=fmt).stride()


@pytest.mark.parametrize("name", ["conv", "convt"])
def test_plain_bf16_same_bits_for_either_input_layout(name):
    """The plain bf16 versions give the same bits for a channels-last input
    as for its NCHW copy."""
    fn = (conv.convtranspose3x3_affine_relu_plain if name == "convt"
          else conv.conv3x3_affine_relu_plain)
    x, wt, scale, shift = _case(np.random.default_rng(1), name == "convt", 2, 16, 20, 9, 11,
                                torch.bfloat16, False)
    want = fn(x, wt, scale, shift)
    got = fn(x.contiguous(memory_format=torch.channels_last), wt, scale, shift)
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("transposed,cin,cout", [
    (False, 13, 20),    # tiles of 32; Cin not a multiple of 8 or 16
    (False, 21, 100),   # tiles of 128, Cout padded
    (False, 5, 44),     # tiles of 64
    (True, 13, 20),     # the transposed conv's (Cin, Cout, 3, 3) weight, tiles of 32
    (True, 21, 70),     # tiles of 64, two of them
])
def test_bf16_operand_matches_index_formula(transposed, cin, cout):
    """op[t, c, tap, g, n, j] = w9[t bn + n, 16 c + 8 g + j, tap] in bf16,
    zero where the output or input channel is padding; w9 the (Cout, Cin,
    9) weight, tap = 3 a + b of the (Cout, Cin, 3, 3) or (Cin, Cout, 3, 3)
    weight."""
    rng = np.random.default_rng(2)
    shape = (cin, cout, 3, 3) if transposed else (cout, cin, 3, 3)
    weight = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    bn = conv.bf16_tile_n(cout, transposed)
    if transposed:
        assert bn == (64 if cout > 32 else 32)
    else:
        assert bn == (128 if cout > 64 else 64 if cout > 32 else 32)
    op = conv.cached_bf16_operand(weight, transposed)
    nt, chunks = -(-cout // bn), -(-cin // 16)
    assert op.shape == (nt, chunks, 9, 2, bn, 8) and op.dtype == torch.bfloat16
    w = weight.to(torch.bfloat16)
    want = torch.zeros(op.shape, dtype=torch.bfloat16)
    for t in range(nt):
        for c in range(chunks):
            for tap in range(9):
                for g in range(2):
                    for n in range(bn):
                        for j in range(8):
                            co, ci = t * bn + n, 16 * c + 8 * g + j
                            if co < cout and ci < cin:
                                want[t, c, tap, g, n, j] = (w[ci, co, tap // 3, tap % 3]
                                                            if transposed else
                                                            w[co, ci, tap // 3, tap % 3])
    assert torch.equal(op, want)


def test_bf16_operand_cached_per_weight_version():
    """The operand is arranged once per weight version: the same tensor
    again while the weight is unchanged; re-arranged after an in-place
    update, after `load_state_dict`, and for a new tensor of the same
    shape (never another weight's entry)."""
    torch.manual_seed(0)
    layer = torch.nn.Conv2d(13, 20, 3)
    first = conv.cached_bf16_operand(layer.weight, False)
    assert conv.cached_bf16_operand(layer.weight, False) is first

    def fresh(weight):
        return conv.bf16_weight_operand(weight.detach().reshape(20, 13, 9), 32)

    with torch.no_grad():
        layer.weight.add_(1.0)
    moved = conv.cached_bf16_operand(layer.weight, False)
    assert moved is not first and torch.equal(moved, fresh(layer.weight))
    assert not torch.equal(moved, first)

    other = torch.nn.Conv2d(13, 20, 3)
    layer.load_state_dict(other.state_dict())
    loaded = conv.cached_bf16_operand(layer.weight, False)
    assert torch.equal(loaded, fresh(other.weight)) and not torch.equal(loaded, moved)

    twin = layer.weight.detach().clone() * 2
    assert torch.equal(conv.cached_bf16_operand(twin, False), fresh(twin))
    assert conv.cached_bf16_operand(layer.weight, False) is loaded


def test_bf16_operand_cache_entry_goes_with_its_weight():
    """A weight's entry is dropped when the weight is freed, so a new
    tensor at a reused address finds no stale operand."""
    weight = torch.randn(20, 13, 3, 3)
    conv.cached_bf16_operand(weight, False)
    key = id(weight)
    assert key in conv._BF16_OPERANDS
    del weight
    assert key not in conv._BF16_OPERANDS
    for _ in range(8):  # tensors that may land at the freed address
        new = torch.randn(20, 13, 3, 3)
        assert torch.equal(conv.cached_bf16_operand(new, False),
                           conv.bf16_weight_operand(new.reshape(20, 13, 9), 32))


@pytest.mark.parametrize("cin", [3, 8, 13, 16])
@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
def test_channels_last8(cin, channels_last):
    """(B, H, W, C8) contiguous: x's channels, then zeros up to a multiple
    of 8; a channels-last x whose C is a multiple of 8 is taken as it is."""
    x = torch.randn(2, cin, 5, 7).to(torch.bfloat16)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    got = conv.channels_last8(x)
    c8 = -(-cin // 8) * 8
    assert got.shape == (2, 5, 7, c8) and got.is_contiguous()
    assert torch.equal(got[..., :cin], x.permute(0, 2, 3, 1))
    assert not got[..., cin:].any()
    if channels_last and cin % 8 == 0:
        assert got.data_ptr() == x.data_ptr()
