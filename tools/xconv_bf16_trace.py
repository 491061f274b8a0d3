#!/usr/bin/env python3
"""Phase timings inside the bf16 fused XConv kernel, on one NVIDIA card.

    python tools/xconv_bf16_trace.py [--out DIR]

Builds a copy of `heterofusionrcnn_torch/ops/csrc` in DIR (default
outputs/xconv_bf16_trace) whose `xconv_bf16.cuh` records `clock64()` at
the kernel's phase boundaries, in CTA 0 only: producer thread 0 at each
tile's start and end of set-up and, per chunk, when its rows are staged,
when its ring slot is free and when it is stored; consumer thread 0 of
warpgroup 0 around each wait for a ring slot, after each Wc stage's wait
and after each `wgmma.wait_group`. The records go to the launch's `partial`
buffer (unused with one split). It then launches the kernel on a few
main path shapes (seeded random inputs, as `tools/xconv_ablation.py`),
twice each, and prints the card's name and power limit and, per shape, the
median cycles of each interval: for the producer, set-up, a feature
chunk's staging (the gather's wait), a lifted chunk's staging (the lift),
the wait for a free slot and the store (the X-mix); for the consumer, a
slot's wait, a k-step from the stage's arrival to the product's wait, and
from there to the next stage's arrival (release, refill, the next wait).
The instrumented library's outputs are not checked; its timings say where
CTA 0's cycles go.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [  # (B, N, P, K, Cf, Cin, D)
    (400, 512, 512, 4, 128, 672, 512),
    (400, 512, 128, 8, 128, 640, 512),
    (400, 32, 8, 12, 256, 1280, 1024),
    (4, 4096, 16384, 8, 64, 320, 256),
]
SLOTS = 4000  # records a thread
P_TILE, P_SETUP, P_STAGED, P_EMPTY, P_STORED = 1, 2, 3, 4, 5
C_FULL_WAIT, C_FULL_OK, C_STAGE_OK, C_WAITED, C_LAST = 11, 12, 13, 14, 15
# (text in xconv_bf16.cuh, text to put before or after it)
TRACE = "if ({who}) {{ trb[2 * tr_base + 2 * tr_n] = clock64(); trb[2 * tr_base + 2 * tr_n + 1] = {ev}; ++tr_n; }}\n"
PRODUCER = "blockIdx.x == 0 && pt == 0 && tr_n < SLOTS"
CONSUMER = "blockIdx.x == 0 && tid == 0 && tr_n < SLOTS"
EDITS = [
    ("after", "  const int tid = threadIdx.x;\n",
     "  long long* trb = reinterpret_cast<long long*>(a.partial);\n  int tr_n = 0;\n"
     "  const int tr_base = tid == 0 ? SLOTS : 0;\n"),
    ("before", "      // --- the tile's set-up: rows, local coordinates (rounded), X, h.\n",
     "      " + TRACE.format(who=PRODUCER, ev=P_TILE)),
    ("after", "      named_bar_sync(1, 128);  // X and h complete, the staging free\n",
     "      " + TRACE.format(who=PRODUCER, ev=P_SETUP)),
    ("after", "        named_bar_sync(1, 128);  // the chunk's rows are staged\n",
     "        " + TRACE.format(who=PRODUCER, ev=f"{P_STAGED} + 100 * (li >= 0)")),
    ("after", "        ring_wait(empty + slot, ((gc / R) & 1) ^ 1, cl);\n",
     "        " + TRACE.format(who=PRODUCER, ev=P_EMPTY)),
    ("after", "        named_bar_sync(1, 128);  // the slot is stored everywhere; the staging is free\n",
     "        " + TRACE.format(who=PRODUCER, ev=P_STORED)),
    ("before", "        ring_wait(full + slot, (gc / R) & 1, cl);\n",
     "        " + TRACE.format(who=CONSUMER, ev=C_FULL_WAIT)),
    ("after", "        ring_wait(full + slot, (gc / R) & 1, cl);\n",
     "        " + TRACE.format(who=CONSUMER, ev=C_FULL_OK)),
    ("after", "          wait_or_trap<false>(bf + st, (bs / S) & 1);\n",
     "          " + TRACE.format(who=CONSUMER, ev=C_STAGE_OK)),
    ("after", "          bf16conv::wgmma_wait<1>();\n",
     "          " + TRACE.format(who=CONSUMER, ev=C_WAITED)),
    ("before", "      bf16conv::wgmma_wait<0>();\n",
     "      " + TRACE.format(who=CONSUMER, ev=C_LAST)),
]


def instrument(src: str) -> str:
    for where, anchor, text in EDITS:
        if anchor not in src:
            raise RuntimeError(f"the kernel source no longer holds {anchor!r}")
        src = src.replace(anchor, text + anchor if where == "before" else anchor + text, 1)
    return f"#define SLOTS {SLOTS}\n" + src


def intervals(recs, first, second):
    """Cycles from each `first` event to the next event when that is `second`."""
    out = []
    for (t0, e0), (t1, e1) in zip(recs, recs[1:]):
        if e0 in first and e1 in second:
            out.append(t1 - t0)
    return out


def median(xs):
    return f"{statistics.median(xs):.0f} ({len(xs)})" if xs else "-"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join("outputs", "xconv_bf16_trace"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from heterofusionrcnn_torch.ops import dispatch, xconv

    if not torch.cuda.is_available():
        print("xconv_bf16_trace: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    csrc = os.path.join(ROOT, "heterofusionrcnn_torch", "ops", "csrc")
    os.makedirs(args.out, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(csrc, f), args.out)
    header = os.path.join(args.out, "xconv_bf16.cuh")
    with open(header) as f:
        text = instrument(f.read())
    with open(header, "w") as f:
        f.write(text)
    so = os.path.abspath(os.path.join(args.out, "libxconv.so"))
    subprocess.run([dispatch._nvcc(), *dispatch._ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", so, os.path.join(args.out, "xconv.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.hfr_xconv_bf16.argtypes = xconv.XCONV_BF16_KERNEL.functions["hfr_xconv_bf16"] + [
        ctypes.c_void_p]
    lib.hfr_xconv_bf16.restype = ctypes.c_int
    gen = torch.Generator().manual_seed(0)
    for b, n, p, k, cf, cin, d in SHAPES:
        cp = cin - cf

        def rand(*s, scale=1.0):
            return (torch.randn(*s, generator=gen) * scale).cuda()

        w = xconv.XConvWeights(
            rand(3, cf), rand(cf), rand(cf), rand(cf, cf, scale=0.1), rand(cf), rand(cf),
            rand(k, cin, d, scale=0.01), rand(d), rand(d), rand(3 * k, k * k), rand(k * k),
            rand(k * k), rand(k, k, k), rand(k * k), rand(k * k), rand(k, k, k), rand(k * k),
            rand(k * k))
        wt = xconv.xconv_weight_operand_bf16(w.wc, cf)
        pts, qrs = rand(b, n, 3), rand(b, p, 3)
        fts = rand(b, n, cp).to(torch.bfloat16)
        idx = torch.randint(0, n, (b, p, k), generator=gen, dtype=torch.int32).cuda()
        out = torch.empty(b, p, d, device="cuda", dtype=torch.bfloat16)
        trace = torch.zeros(2 * 2 * SLOTS, dtype=torch.int64, device="cuda")
        ws = [w.w1, w.s1, w.b1, w.w2, w.s2, w.b2, w.wx0, w.sx0, w.bx0, w.wx1, w.sx1, w.bx1,
              w.wx2, w.sx2, w.bx2, wt, w.sc, w.bc]
        call = dispatch.pointers(pts, fts, qrs, idx, *ws, out, trace) + [
            ctypes.c_int(v) for v in (b, n, p, k, cf, cp, d, wt.shape[0] * wt.shape[4], 1, 1,
                                      int(cp % 8 == 0))]
        for _ in range(2):  # the second launch is timed warm
            trace.zero_()
            if lib.hfr_xconv_bf16(*call, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)):
                raise RuntimeError("launch refused")
            torch.cuda.synchronize()
        t = trace.view(2, SLOTS, 2).cpu().tolist()
        prod = [(c, e) for c, e in t[0] if e]
        cons = [(c, e) for c, e in t[1] if e]
        feat, lift = {P_STAGED}, {P_STAGED + 100}
        print(f"{b}x{p} K{k} Cf{cf} Cin{cin} D{d}, CTA 0, median cycles (count):", flush=True)
        print("  producer: set-up " + median(intervals(prod, {P_TILE}, {P_SETUP}))
              + ", feature chunk staged " + median(intervals(prod, {P_STORED, P_SETUP}, feat))
              + ", lifted chunk staged " + median(intervals(prod, {P_STORED, P_SETUP}, lift))
              + ", slot free " + median(intervals(prod, feat | lift, {P_EMPTY}))
              + ", mixed and stored " + median(intervals(prod, {P_EMPTY}, {P_STORED})), flush=True)
        print("  consumer: slot wait " + median(intervals(cons, {C_FULL_WAIT}, {C_FULL_OK}))
              + ", stage to product waited " + median(intervals(cons, {C_STAGE_OK}, {C_WAITED}))
              + ", product waited to next stage "
              + median(intervals(cons, {C_WAITED}, {C_STAGE_OK}))
              + ", last product to next slot wait "
              + median(intervals(cons, {C_WAITED}, {C_FULL_WAIT})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
