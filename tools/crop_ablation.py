#!/usr/bin/env python3
"""The crop row gather (`crop.cu`) on one NVIDIA card: its kernels alone on
several trees in turns, and the op's time split on one tree.

    python tools/crop_ablation.py TREE [TREE ...] [--rounds 6] [--out DIR] [--calls CALLS]
    python tools/crop_ablation.py --split [--tree TREE] [--out DIR] [--calls CALLS]

The calls (both modes): the crop of the batch-4 two-stage forward at full
width, switches on, recorded once from a forward of the port in float32
(cell A) and in bf16 (cell G) with `chip_smoke.py`'s seed-0 weights,
BatchNorm statistics and inputs: `src` (4, 16384, 288), `idx` (400, 512)
int32, `box_ind` (400,) int64 as `pc_crop_and_sample` hands them over.
Random weights leave most boxes empty (their rows all index 0), so the
recorded call reads few distinct rows; beside it runs the all-distinct call
of the same shapes, `idx` uniform in [0, 16384) from seed 0, whose
gathered rows cover nearly the whole source. Recorded calls are kept in
CALLS (default outputs/crop_calls.pt) and read from there by later runs.

Turns (TREE ...): each tree's `heterofusionrcnn_torch/ops/csrc/crop.cu` is
built (nvcc for sm_90a, all at once) into its own library and its C entry
called through ctypes, the kernel alone: the mean of REPS launches between
CUDA events, each tree in turn (A B ..., then reversed) for `--rounds`
rounds, the median kept. A tree whose crop.cu takes the indices as they
come (int32 or int64, `int idx64` in its C entries) gets them so; an older
tree (its crop.cu taking int32 indices only) gets int32 copies made
beforehand. Every output is held against the plain
gather, bit for bit, before it is timed. Each line gives ms, the share of
the call's bytes bound (each distinct source row read once, each output
row written once, the indices) and GB/s of output.

Split (--split): TREE's port (default this checkout) runs the op
`crop_gather` on the same calls: the op per call back to back (CUDA
events), the host time per call (host clock over REPS calls, no
synchronisation inside), the device time by kernel under torch.profiler
(the crop kernel alone, and any other kernel the op launches, with their
launches per call), the wrapper alone (the op's CUDA implementation
`_crop_cuda` called directly) and the pieces of its host work.

Prints the card's name and power limit first; writes DIR/crop_ablation.json
(or crop_split.json). DIR defaults to outputs/crop_ablation.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
REPS = 20
SEED = 0
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
INDEX_MARK = "int idx64"  # the C entries of a crop.cu that take int32 or int64 indices


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def record_calls(path: str) -> dict:
    """{(dtype, case): (src, idx, box_ind)} on the card, from `path` or
    from one float32 and one bf16 forward of the port on sys.path."""
    import torch

    if os.path.exists(path):
        saved = torch.load(path)
        return {tuple(k.split("/")): tuple(t.cuda() for t in v) for k, v in saved.items()}
    import chip_smoke as cs
    from heterofusionrcnn_torch.inference import build_two_stage

    torch.set_grad_enabled(False)
    calls = {}
    for dtype in ("float32", "bfloat16"):
        det, inputs = build_two_stage(cs.BATCH, cs.SEED, "cuda", conv_kernels=True,
                                      crop_kernel=True, compute_dtype=dtype)
        cs.randomize_batchnorm(det, cs.SEED)
        with cs.recording(ops=("crop_gather",)) as rec:
            det(*inputs)
        torch.cuda.synchronize()
        (src, idx, box_ind), _ = rec["crop_gather"][0]
        calls[(dtype, "recorded")] = (src.clone(), idx.clone(), box_ind.clone())
        gen = torch.Generator().manual_seed(SEED)
        spread = torch.randint(0, src.shape[1], tuple(idx.shape), generator=gen,
                               dtype=torch.int32).cuda()
        calls[(dtype, "distinct")] = (src.clone(), spread, box_ind.clone())
        del det, inputs
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"/".join(k): tuple(t.cpu() for t in v) for k, v in calls.items()}, path)
    return calls


def call_bytes(src, idx, box_ind):
    """(bytes bound, output bytes) of one call: each distinct gathered row
    read once, each output row written once, the indices read once."""
    import torch

    n, c = src.shape[1], src.shape[2]
    rows = (box_ind.long()[:, None] * n + idx.long()).reshape(-1)
    distinct = int(torch.unique(rows).numel())
    out = idx.numel() * c * src.element_size()
    return (distinct * c * src.element_size() + out + idx.numel() * idx.element_size()
            + box_ind.numel() * box_ind.element_size()), out


def plain(src, idx, box_ind):
    b, n, c = src.shape
    flat = (box_ind.long()[:, None] * n + idx.long()).reshape(-1)
    return src.reshape(b * n, c)[flat].reshape(*idx.shape, c)


# --- turns -------------------------------------------------------------------


def build_libs(trees, out):
    """{label: (library path, takes both index dtypes)}: each tree's crop.cu built
    from a copy of its csrc/, all nvcc processes at once."""
    from heterofusionrcnn_torch.ops.dispatch import _nvcc

    procs, libs = {}, {}
    for i, tree in enumerate(trees):
        label = f"{i}:{os.path.basename(os.path.normpath(tree))}"
        csrc = os.path.join(tree, "heterofusionrcnn_torch", "ops", "csrc")
        d = os.path.join(out, f"tree{i}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        src = os.path.join(d, "crop.cu")
        lib = os.path.join(d, "libcrop.so")
        procs[label] = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", lib, src],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
        libs[label] = (os.path.abspath(lib), INDEX_MARK in open(src).read())
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        print(f"{label}: " + " | ".join(l.strip() for l in log.splitlines()
                                        if "registers" in l or "spill" in l), flush=True)
    return libs


def entry(lib_path, bf16, current):
    lib = ctypes.CDLL(lib_path)
    fn = getattr(lib, "hfr_crop_gather_bf16" if bf16 else "hfr_crop_gather")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P] + [I] * (6 if current else 4) + [P]
    fn.restype = I
    return fn


def timed(fn, args, stream, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args, stream)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def turns(args) -> int:
    import torch

    sys.path.insert(0, ROOT)
    calls = record_calls(args.calls)
    libs = build_libs(args.trees, args.out)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    P, I = ctypes.c_void_p, ctypes.c_int
    result = []
    for (dtype, case), (src, idx, box_ind) in calls.items():
        bf16 = dtype == "bfloat16"
        nb, rows = idx.shape
        b, n, c = src.shape
        bound_bytes, out_bytes = call_bytes(src, idx, box_ind)
        bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
        want = plain(src, idx, box_ind)
        variants = {}
        for label, (path, current) in libs.items():
            out = torch.empty_like(want)
            if current:
                i_, b_ = idx, box_ind
                tail = [I(idx.element_size() == 8), I(box_ind.element_size() == 8)]
            else:
                i_, b_ = idx.to(torch.int32), box_ind.to(torch.int32)
                tail = []
            call = [P(src.data_ptr()), P(i_.data_ptr()), P(b_.data_ptr()), P(out.data_ptr()),
                    I(nb), I(n), I(rows), I(c), *tail]
            fn = entry(path, bf16, current)
            err = fn(*call, stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{label}: launch refused ({err})")
            if not torch.equal(out, want):
                raise AssertionError(f"{label}: {dtype} {case} differs from the plain gather")
            variants[label] = (fn, call, [], (i_, b_, out))  # the tensors `call` points to
        for r in range(args.rounds):
            order = list(variants) if r % 2 == 0 else list(variants)[::-1]
            for name in order:
                fn, call, times, _ = variants[name]
                times.append(timed(fn, call, stream, REPS))
        line = []
        for name, (_, _, times, _) in variants.items():
            ms = statistics.median(times)
            result.append(dict(dtype=dtype, case=case, tree=name, ms=ms, runs=times,
                               bound_ms=bound_ms, share=bound_ms / ms,
                               out_gb_per_s=out_bytes / ms * 1e-6))
            line.append(f"{name} {ms:.4f} ms ({bound_ms / ms:.3f} of bound, "
                        f"{out_bytes / ms * 1e-6:.0f} GB/s out)")
        print(f"{dtype} {case} {b}x{n}x{c} -> {nb}x{rows} (bound {bound_ms:.4f} ms): "
              + ", ".join(line), flush=True)
    with open(os.path.join(args.out, "crop_ablation.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


# --- split -------------------------------------------------------------------


def op_split(fn, reps):
    """The op per call (CUDA events, back to back), its host time per call,
    and its device time by kernel under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    op_ms = start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):  # a warm-up step, whose records are dropped, then reps calls
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    kernels = {e.key: (e.count / reps, e.device_time_total / 1e3 / reps)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0
               and not e.key.startswith("ProfilerStep")}  # the step's own range
    crop = [v for k, v in kernels.items() if "crop_gather_kernel" in k]
    other = {k[:80]: v for k, v in kernels.items() if "crop_gather_kernel" not in k}
    return dict(op_ms=op_ms, host_us=host_us,
                kernel_ms=sum(v[1] for v in crop), kernel_launches=sum(v[0] for v in crop),
                other_ms=sum(v[1] for v in other.values()),
                other_launches=sum(v[0] for v in other.values()), other=other)


def host_us(fn, reps=200):
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def split(args) -> int:
    import torch

    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from heterofusionrcnn_torch.ops import cropping, dispatch

    if not os.path.abspath(cropping.__file__).startswith(tree):
        raise RuntimeError(f"imported {cropping.__file__}, not the port of {tree}")
    torch.set_grad_enabled(False)
    calls = record_calls(args.calls)
    result = []
    for (dtype, case), (src, idx, box_ind) in calls.items():
        bound_bytes, _ = call_bytes(src, idx, box_ind)
        bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
        if not torch.equal(cropping.crop_gather(src, idx, box_ind), plain(src, idx, box_ind)):
            raise AssertionError(f"{dtype} {case}: the op differs from the plain gather")
        op = op_split(lambda: cropping.crop_gather(src, idx, box_ind), REPS)
        wrapper = host_us(lambda: cropping._crop_cuda(src, idx, box_ind))
        torch.cuda.synchronize()
        pieces = dict(
            op=host_us(lambda: torch.ops.hfr.crop_gather(src, idx, box_ind)),
            wrapper=wrapper,
            current_stream=host_us(lambda: torch.cuda.current_stream().cuda_stream),
            empty=host_us(lambda: torch.empty((idx.shape[0], idx.shape[1], src.shape[2]),
                                              dtype=src.dtype, device=src.device)),
            pointers=host_us(lambda: dispatch.pointers(src, idx, box_ind)),
            contiguous=host_us(lambda: (src.contiguous(), idx.contiguous(),
                                        box_ind.contiguous())),
            one_device=host_us(lambda: dispatch.one_device(src, idx, box_ind)),
        )
        torch.cuda.synchronize()
        row = dict(dtype=dtype, case=case, bound_ms=bound_ms, host_pieces_us=pieces, **op)
        result.append(row)
        print(f"{dtype} {case}: op {op['op_ms']:.4f} ms a call back to back, host "
              f"{op['host_us']:.1f} us a call; profiler: kernel {op['kernel_ms']:.4f} ms "
              f"({op['kernel_launches']:.2f} launches a call, {bound_ms / op['kernel_ms']:.3f} of "
              f"its {bound_ms:.4f} ms bound), other kernels {op['other_ms']:.4f} ms "
              f"({op['other_launches']:.2f} launches a call: {list(op['other'])}); host us: "
              + " ".join(f"{k} {v:.1f}" for k, v in pieces.items()), flush=True)
    with open(os.path.join(args.out, "crop_split.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", help="checkouts whose crop.cu kernels are timed in turns")
    ap.add_argument("--split", action="store_true", help="the op's time split on --tree")
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", default=os.path.join("outputs", "crop_ablation"))
    ap.add_argument("--calls", default=os.path.join("outputs", "crop_calls.pt"))
    args = ap.parse_args(argv)
    args.out, args.calls = os.path.abspath(args.out), os.path.abspath(args.calls)
    import torch

    if not torch.cuda.is_available():
        print("crop_ablation: no CUDA card", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    if args.split:
        return split(args)
    if not args.trees:
        ap.error("give one or more trees, or --split")
    return turns(args)


if __name__ == "__main__":
    sys.exit(main())
