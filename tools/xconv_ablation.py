#!/usr/bin/env python3
"""Where the fused XConv kernel's time goes, on one NVIDIA card.

    python tools/xconv_ablation.py [--out DIR]

Builds `heterofusionrcnn_torch/ops/csrc/xconv.cu` as it is and in variants
that each drop part of the pipeline by a text substitution (their outputs
are wrong; their times say which warpgroup holds the kernel back):

  full          the kernel as it is
  no_lift       the lifter skips its lift arithmetic
  no_mma        the consumers skip their wgmma products
  lifter_only   no products, no feature gathers, no X @ in: the lifter alone
  mixer_only    no lift arithmetic and no products: the mixer alone

and times each (CUDA events, mean of REPS launches after a warm-up) on main
path shapes with seeded random inputs, printing ms and FP32-grade TFLOP/s
of the separable conv per shape and variant, and the card's name and power
limit. The libraries land in DIR (default outputs/xconv_ablation).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 5
# (B, N, P, K, Cf, Cin, D): RPN xdconv_5, RCNN layers 1-4, the few-query RPN
# xconv_5 and xdconv_2 (split path).
SHAPES = [
    (4, 16384, 16384, 8, 64, 320, 256),
    (400, 512, 512, 4, 128, 672, 512),
    (400, 128, 128, 8, 128, 640, 512),
    (400, 128, 32, 12, 128, 640, 1024),
    (400, 32, 8, 12, 256, 1280, 1024),
    (4, 256, 64, 8, 256, 1280, 1024),
    (4, 1024, 256, 8, 256, 1280, 1024),
]
NO_LIFT = ("      for (int h0 = 0; h0 < cf8; h0 += kHB) {",
           "      for (int h0 = 0; h0 < 0; h0 += kHB) {")
NO_MMA = ("      if (active) {\n        const float* sa", "      if (false) {\n        const float* sa")
NO_GATHER = ("        if (pg < ce) {\n          gather(pg, s_in + (ng % L::kNG) * kBM * L::QS);",
             "        if (false) {\n          gather(pg, s_in + (ng % L::kNG) * kBM * L::QS);")
NO_X = ("          for (int j = 0; j < K; ++j) {\n            const float4 u",
        "          for (int j = 0; j < 0; ++j) {\n            const float4 u")
VARIANTS = {
    "full": (),
    "no_lift": (NO_LIFT,),
    "no_mma": (NO_MMA,),
    "lifter_only": (NO_MMA, NO_GATHER, NO_X),
    "mixer_only": (NO_LIFT, NO_MMA),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join("outputs", "xconv_ablation"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from heterofusionrcnn_torch.ops import dispatch, xconv

    csrc = os.path.join(ROOT, "heterofusionrcnn_torch", "ops", "csrc")
    sources = variant_sources(open(os.path.join(csrc, "xconv.cu")).read())
    if not torch.cuda.is_available():
        print("xconv_ablation: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    for header in os.listdir(csrc):  # xconv.cu's headers, and theirs
        if header.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, header), args.out)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(args.out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [dispatch._nvcc(), *dispatch._ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.abspath(os.path.join(args.out, f"{name}.so")))
        lib.hfr_xconv.argtypes = xconv.XCONV_KERNEL.functions["hfr_xconv"] + [ctypes.c_void_p]
        lib.hfr_xconv.restype = ctypes.c_int
        libs[name] = lib

    gen = torch.Generator().manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for b, n, p, k, cf, cin, d in SHAPES:
        cp = cin - cf

        def rand(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen) * scale).cuda()

        w = xconv.XConvWeights(
            rand(3, cf), rand(cf), rand(cf), rand(cf, cf, scale=0.1), rand(cf), rand(cf),
            rand(k, cin, d, scale=0.01), rand(d), rand(d), rand(3 * k, k * k), rand(k * k),
            rand(k * k), rand(k, k, k), rand(k * k), rand(k * k), rand(k, k, k), rand(k * k),
            rand(k * k))
        wt = xconv.xconv_weight_operand(w.wc, cf)
        pts, qrs, fts = rand(b, n, 3), rand(b, p, 3), rand(b, n, cp)
        idx = torch.randint(0, n, (b, p, k), generator=gen, dtype=torch.int32).cuda()
        splits = xconv.plan_xconv(b * p, k, cf, cp, d, torch.cuda.get_device_properties(0)
                                  .multi_processor_count).splits
        out = torch.empty(b, p, d, device="cuda")
        partial = torch.empty(splits, b * p, d, device="cuda")
        ws = [w.w1, w.s1, w.b1, w.w2, w.s2, w.b2, w.wx0, w.sx0, w.bx0, w.wx1, w.sx1, w.bx1,
              w.wx2, w.sx2, w.bx2, wt, w.sc, w.bc]
        call = dispatch.pointers(pts, fts, qrs, idx, *ws, out, partial) + [
            ctypes.c_int(v) for v in (b, n, p, k, cf, cp, d, wt.shape[2] * 8, 1, splits,
                                      int(cp % 4 == 0))]
        flops = 2.0 * b * p * k * cin * d
        row = []
        for name, lib in libs.items():
            if lib.hfr_xconv(*call, stream):
                raise RuntimeError(f"{name}: launch refused")
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                lib.hfr_xconv(*call, stream)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / REPS
            row.append(f"{name} {ms:.4f} ms ({flops / ms * 1e-9:.1f} TFLOP/s)")
        print(f"{b}x{p} K{k} Cf{cf} Cin{cin} D{d} x{splits}: " + ", ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
