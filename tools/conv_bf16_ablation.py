#!/usr/bin/env python3
"""Where the bf16 conv and transposed-conv kernels' time goes, on one NVIDIA card.

    python tools/conv_bf16_ablation.py [--out DIR]

Builds `heterofusionrcnn_torch/ops/csrc/conv.cu` and `convt.cu` with
`conv_bf16.cuh` as it is and in variants that each drop part of the
pipeline by a text substitution (their outputs are wrong; their times say
which part holds the kernel back):

  full            the kernels as they are
  no_mma          the consumers skip their wgmma products
  no_epilogue     the consumers skip the epilogue (no output is written)
  loads_only      no products and no epilogue: the producer's copies alone
  no_input_loads  the producer copies no input boxes (the weight only)
  no_weight_loads the producer copies no weight slices (the input only)

and times each (CUDA events, mean of REPS launches after a warm-up) on the
main path's bf16 shapes at batch 4 with seeded random inputs, on the
operands the op prepares (`ops/conv.py`: `channels_last8`,
`cached_bf16_operand`), printing ms per shape and variant, and the card's
name and power limit. The libraries land in DIR (default
outputs/conv_bf16_ablation).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20
# (transposed, B, Cin, Cout, H, W): the VGG pyramid's full-resolution,
# 180x600, 90x300 and 45x150 convs and its three transposed convs.
SHAPES = [
    (False, 4, 3, 32, 360, 1200),
    (False, 4, 32, 32, 360, 1200),
    (False, 4, 64, 64, 180, 600),
    (False, 4, 128, 128, 90, 300),
    (False, 4, 256, 256, 45, 150),
    (False, 4, 64, 32, 360, 1200),
    (True, 4, 256, 128, 45, 150),
    (True, 4, 32, 32, 180, 600),
]
NO_MMA = ("          wgmma_bf16(acc[ph][m], ad, bd, accumulate);",
          "          (void)ad; (void)bd; (void)accumulate;")
NO_EPILOGUE = ("    named_bar_sync(1 + wg, 128);  // the buffer's previous tile has been stored",
               "    if (a.relu >= 0) continue;\n    named_bar_sync(1 + wg, 128);")
INPUT_LOADS = ("      tma_load_4d(dst, xmap, bar, c * kKC, x0 - 1, y0 - 1, b);\n"
               "      tma_load_4d(dst + C::PLANE, xmap, bar, c * kKC + 8, x0 - 1, y0 - 1, b);\n")
WEIGHT_LOAD = ("      bulk_load(dst + C::A_BYTES, wt + (size_t)c * (C::B_BYTES / 2), C::B_BYTES, "
               "bar);\n")
EXPECT = "      mbar_expect_tx(bar, 2 * C::BOX + C::B_BYTES);"
VARIANTS = {
    "full": (),
    "no_mma": (NO_MMA,),
    "no_epilogue": (NO_EPILOGUE,),
    "loads_only": (NO_MMA, NO_EPILOGUE),
    "no_input_loads": ((INPUT_LOADS, ""), (EXPECT, "      mbar_expect_tx(bar, C::B_BYTES);")),
    "no_weight_loads": ((WEIGHT_LOAD, ""), (EXPECT, "      mbar_expect_tx(bar, 2 * C::BOX);")),
}


def variant_sources(src: str) -> dict:
    out = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the kernel source no longer holds {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join("outputs", "conv_bf16_ablation"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from heterofusionrcnn_torch.ops import conv, dispatch

    header = (dispatch.CSRC_DIR / "conv_bf16.cuh").read_text()
    sources = variant_sources(header)
    if not torch.cuda.is_available():
        print("conv_bf16_ablation: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    kernels = {}
    for name, text in sources.items():
        d = os.path.abspath(os.path.join(args.out, name))
        os.makedirs(d, exist_ok=True)
        for f in ("conv.cu", "convt.cu", "conv_common.cuh"):
            shutil.copy(dispatch.CSRC_DIR / f, d)
        with open(os.path.join(d, "conv_bf16.cuh"), "w") as f:
            f.write(text)
        kernels[name] = {}
        for src, fn, transposed in (("conv.cu", "hfr_conv3x3_bf16", False),
                                    ("convt.cu", "hfr_convt3x3_bf16", True)):
            base = conv.CONVT_BF16_KERNEL if transposed else conv.CONV_BF16_KERNEL
            k = dispatch.CudaKernel(src, base.functions, exact=False, name=f"{name}_{src}")
            k.source = Path(d) / src
            kernels[name][transposed] = (k, fn)
    dispatch.build_all(k for ks in kernels.values() for k, _ in ks.values())

    gen = torch.Generator().manual_seed(0)
    for transposed, b, cin, cout, h, w in SHAPES:
        x = torch.randn(b, cin, h, w, generator=gen).cuda().to(torch.bfloat16)
        shape = (cin, cout, 3, 3) if transposed else (cout, cin, 3, 3)
        weight = (torch.randn(*shape, generator=gen) * (2.0 / (9 * cin)) ** 0.5).cuda()
        scale, shift = torch.rand(cout, generator=gen).cuda() + 0.5, torch.zeros(cout).cuda()
        x8, wt = conv.channels_last8(x), conv.cached_bf16_operand(weight, transposed)
        row = []
        for name, ks in kernels.items():
            k, fn = ks[transposed]
            ms = cuda_ms(lambda: conv.launch_bf16(k, fn, x8, wt, scale, shift, cout, transposed,
                                                  True), REPS)
            row.append(f"{name} {ms:.4f}")
        kind = "convt" if transposed else "conv"
        print(f"{kind} {b}x{cin}x{h}x{w}->{cout} ms: " + ", ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
