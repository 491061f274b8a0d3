#!/usr/bin/env python3
"""Where the fused XConv kernel's time goes, on one NVIDIA card.

    python tools/xconv_ablation.py [--out DIR]
    python tools/xconv_ablation.py --dtype bfloat16 [--tree TREE] [--out DIR]

Builds the kernel as it is and in variants that each drop part of its work
by a text substitution (their outputs are wrong; their times say which
part holds the kernel back), and times each (CUDA events, mean of REPS
launches after a warm-up) on main path shapes with seeded random inputs,
printing ms and TFLOP/s of the separable conv per shape and variant, and
the card's name and power limit. The libraries land in DIR (default
outputs/xconv_ablation, or outputs/xconv_ablation_bf16).

float32 (`heterofusionrcnn_torch/ops/csrc/xconv.cu`, `hfr_xconv`):

  full          the kernel as it is
  no_lift       the lifter skips its lift arithmetic
  no_mma        the consumers skip their wgmma products
  lifter_only   no products, no feature gathers, no X @ in: the lifter alone
  mixer_only    no lift arithmetic and no products: the mixer alone

bfloat16 (`hfr_xconv_bf16`, the kernel of `csrc/xconv_bf16.cuh`) on the
15 calls of the batch-4 bf16 forward, one line per distinct call. TREE
(default: this checkout) is the root of the checkout whose kernel, Wc
arrangement and plan are timed, for example a `git archive` of a parent
commit; the variants are chosen by the kernel the tree holds. The
warp-specialised `wgmma` kernel:

  full           the kernel as it is
  no_mma         the consumers skip their products (B still streamed)
  no_bload       the consumers skip their Wc bulk copies (stages arrive empty)
  no_gather      the producer skips the feature gathers
  no_lift        the producer skips lift-1 and lift-2
  no_mix         the producer skips X @ in and its loads (it stores zeros)
  producer_only  no products and no Wc copies: the producer alone
  consumer_only  no gathers, lifts or X @ in: the consumers (and the ring) alone
  wc_stream      consumer_only without the products: the Wc stream (and the ring)
  ring_mma       consumer_only without the Wc copies: the products (and the ring)

and the `mma.sync` kernel it replaced:

  full, no_lift (lift-2's loop), no_mma (the products), no_gather (the
  feature loads), no_x (X @ in)
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

# The bf16 forward's XConv calls (B, N, P, K, Cf, Cin, D): the RPN's five
# XConv and six XDConv layers (the last two alike, timed once) and the
# RCNN's four.
BF16_SHAPES = [
    (4, 16384, 16384, 8, 64, 65, 256), (4, 16384, 4096, 8, 64, 320, 256),
    (4, 4096, 1024, 8, 64, 320, 512), (4, 1024, 256, 8, 128, 640, 1024),
    (4, 256, 64, 8, 256, 1280, 1024), (4, 64, 64, 8, 256, 1536, 1024),
    (4, 64, 256, 8, 256, 1280, 1024), (4, 256, 1024, 8, 256, 1280, 512),
    (4, 1024, 4096, 8, 128, 640, 256), (4, 4096, 16384, 8, 64, 320, 256),
    (400, 512, 512, 4, 128, 672, 512), (400, 512, 128, 8, 128, 640, 512),
    (400, 128, 32, 12, 128, 640, 1024), (400, 32, 8, 12, 256, 1280, 1024),
]
BF16_CALLS = {s: 2 if s == (4, 4096, 16384, 8, 64, 320, 256) else 1 for s in BF16_SHAPES}
W_MARK = "wgmma_tile<WN>(acc,"  # the warp-specialised wgmma kernel
# Each edit guards the work with a condition that is false at run time
# (splits >= 1), so every variant keeps the kernel's code and registers.
W_NO_MMA = ("          wgmma_tile<WN>(acc,", "          if (a.splits < 0) wgmma_tile<WN>(acc,")
W_NO_BLOAD = ("      mbar_expect_tx(bar, L::BST);\n",
              "      if (a.splits >= 0) {\n        arrive_cta(bf + st);\n      } else {\n"
              "      mbar_expect_tx(bar, L::BST);\n")
W_NO_BLOAD_END = ("L::BST, bar);\n      ++bl;", "L::BST, bar);\n      }\n      ++bl;")
W_NO_GATHER = [("          if (pending != p) gather(p, fb);",
                "          if (pending != p && a.splits < 0) gather(p, fb);"),
               ("            gather(pn, fb ^ 1);",
                "            if (a.splits < 0) gather(pn, fb ^ 1); else cp_async_commit();")]
W_NO_LIFT = [("            for (int hs = 0; hs < cf16; hs += kKC) {",
              "            for (int hs = 0; hs < (a.splits < 0 ? cf16 : 0); hs += kKC) {"),
             ("          for (int h0 = 0; h0 < cf16; h0 += 8) {",
              "          for (int h0 = 0; h0 < (a.splits < 0 ? cf16 : 0); h0 += 8) {")]
W_NO_MIX = [("              const float4 v = load(j, grp);\n              if (a.with_x) {",
             "              const float4 v = a.splits < 0 ? load(j, grp) : make_float4(0.f, 0.f, 0.f, 0.f);\n"
             "              if (a.with_x && a.splits < 0) {")]
W_VARIANTS = {
    "full": (),
    "no_mma": (W_NO_MMA,),
    "no_bload": (W_NO_BLOAD, W_NO_BLOAD_END),
    "no_gather": tuple(W_NO_GATHER),
    "no_lift": tuple(W_NO_LIFT),
    "no_mix": tuple(W_NO_MIX),
    "producer_only": (W_NO_MMA, W_NO_BLOAD, W_NO_BLOAD_END),
    "consumer_only": (*W_NO_GATHER, *W_NO_LIFT, *W_NO_MIX),
    "wc_stream": (*W_NO_GATHER, *W_NO_LIFT, *W_NO_MIX, W_NO_MMA),
    "ring_mma": (*W_NO_GATHER, *W_NO_LIFT, *W_NO_MIX, W_NO_BLOAD, W_NO_BLOAD_END),
}
S_NO_LIFT = ("      for (int hs = 0; hs < cf16; hs += kKC) {", "      for (int hs = 0; hs < 0; hs += kKC) {")
S_NO_MMA = ("    for (int k = 0; k < K; ++k) {\n      const __nv_bfloat16* sa",
            "    for (int k = 0; k < 0; ++k) {\n      const __nv_bfloat16* sa")
S_NO_GATHER = [("        for (int e = tid; e < kRows * 2; e += kThreads) {",
                "        for (int e = tid; e < 0; e += kThreads) {"),
               ("        for (int e = tid; e < kRows * kKC; e += kThreads) {\n          const int r = e / kKC, cc",
                "        for (int e = tid; e < 0; e += kThreads) {\n          const int r = e / kKC, cc")]
S_NO_X = ("          for (int j = 0; j < K; ++j) {\n            const float x = xk[j];",
          "          for (int j = 0; j < 0; ++j) {\n            const float x = xk[j];")
S_VARIANTS = {
    "full": (),
    "no_lift": (S_NO_LIFT,),
    "no_mma": (S_NO_MMA,),
    "no_gather": tuple(S_NO_GATHER),
    "no_x": (S_NO_X,),
}


def variant_sources(src: str, variants=None) -> dict:
    out = {}
    for name, edits in (variants or VARIANTS).items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the kernel source no longer holds {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--variants", default=None, help="comma-separated subset (bfloat16)")
    args = ap.parse_args(argv)
    if args.dtype == "bfloat16":
        return main_bf16(args)
    args.out = args.out or os.path.join("outputs", "xconv_ablation")
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


def build_variants(csrc: str, out: str, header: str, variants: dict, dispatch) -> dict:
    """Each variant's xconv.cu library, built from its own copy of csrc with
    `header` edited; all nvcc processes at once. Returns {name: .so path}."""
    src = open(os.path.join(csrc, header)).read()
    texts = variant_sources(src, variants)
    procs = {}
    for name, text in texts.items():
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(csrc):
            if f.endswith((".cu", ".cuh")):
                shutil.copy(os.path.join(csrc, f), d)
        with open(os.path.join(d, header), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [dispatch._nvcc(), *dispatch._ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", os.path.join(d, "libxconv.so"),
             os.path.join(d, "xconv.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = os.path.abspath(os.path.join(out, name, "libxconv.so"))
    return libs


def main_bf16(args) -> int:
    """The bf16 arm: TREE's kernel, arrangement and plan, its variants."""
    tree = os.path.abspath(args.tree)
    out = os.path.abspath(args.out or os.path.join("outputs", "xconv_ablation_bf16"))
    sys.path.insert(0, tree)
    import torch

    from heterofusionrcnn_torch.ops import dispatch, xconv

    if not os.path.abspath(xconv.__file__).startswith(tree):
        raise RuntimeError(f"imported {xconv.__file__}, not the port of {tree}")
    if not torch.cuda.is_available():
        print("xconv_ablation: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    csrc = os.path.join(tree, "heterofusionrcnn_torch", "ops", "csrc")
    header = "xconv_bf16.cuh"
    variants = W_VARIANTS if W_MARK in open(os.path.join(csrc, header)).read() else S_VARIANTS
    if args.variants:
        variants = {k: variants[k] for k in args.variants.split(",")}
    print(f"tree {tree}: variants {list(variants)}", flush=True)
    libs = {}
    for name, path in build_variants(csrc, out, header, variants, dispatch).items():
        lib = ctypes.CDLL(path)
        lib.hfr_xconv_bf16.argtypes = xconv.XCONV_BF16_KERNEL.functions["hfr_xconv_bf16"] + [
            ctypes.c_void_p]
        lib.hfr_xconv_bf16.restype = ctypes.c_int
        libs[name] = lib
    gen = torch.Generator().manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    totals = {name: 0.0 for name in libs}
    for shape in BF16_SHAPES:
        b, n, p, k, cf, cin, d = shape
        cp = cin - cf

        def rand(*s, scale=1.0):
            return (torch.randn(*s, generator=gen) * scale).cuda()

        w = xconv.XConvWeights(
            rand(3, cf), rand(cf), rand(cf), rand(cf, cf, scale=0.1), rand(cf), rand(cf),
            rand(k, cin, d, scale=0.01), rand(d), rand(d), rand(3 * k, k * k), rand(k * k),
            rand(k * k), rand(k, k, k), rand(k * k), rand(k * k), rand(k, k, k), rand(k * k),
            rand(k * k))
        wt = xconv.xconv_weight_operand_bf16(w.wc, cf)
        dp = wt.shape[0] * wt.shape[4] if wt.dim() == 6 else wt.shape[2]
        pts, qrs = rand(b, n, 3), rand(b, p, 3)
        fts = rand(b, n, cp).to(torch.bfloat16)
        idx = torch.randint(0, n, (b, p, k), generator=gen, dtype=torch.int32).cuda()
        plan = xconv.plan_xconv(b * p, k, cf, cp, d, sms, torch.bfloat16)
        out = torch.empty(b, p, d, device="cuda", dtype=torch.bfloat16)
        partial = torch.empty(plan.splits, b * p, d, device="cuda")
        ws = [w.w1, w.s1, w.b1, w.w2, w.s2, w.b2, w.wx0, w.sx0, w.bx0, w.wx1, w.sx1, w.bx1,
              w.wx2, w.sx2, w.bx2, wt, w.sc, w.bc]
        call = dispatch.pointers(pts, fts, qrs, idx, *ws, out, partial) + [
            ctypes.c_int(v) for v in (b, n, p, k, cf, cp, d, dp, 1, plan.splits,
                                      int(cp % 8 == 0))]
        flops = 2.0 * b * p * k * cin * d
        row = []
        for name, lib in libs.items():
            err = lib.hfr_xconv_bf16(*call, stream)
            if err:
                raise RuntimeError(f"{name}: launch refused ({err})")
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                lib.hfr_xconv_bf16(*call, stream)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / REPS
            totals[name] += ms * BF16_CALLS[shape]
            row.append(f"{name} {ms:.4f} ms ({flops / ms * 1e-9:.1f} TFLOP/s)")
        print(f"{b}x{p} K{k} Cf{cf} Cin{cin} D{d} cluster {getattr(plan, 'cluster', 1)} "
              f"x{plan.splits} (bound {flops / 989e9:.4f} ms): " + ", ".join(row), flush=True)
    print("forward (15 calls): " + ", ".join(f"{k} {v:.4f} ms" for k, v in totals.items()),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
