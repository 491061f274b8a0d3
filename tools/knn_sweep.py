#!/usr/bin/env python3
"""The KNN kernel's two arms on every call of the main path, on one NVIDIA card.

    python tools/knn_sweep.py [--out DIR]

Sets the arm threshold (`grouping.KNN_SORTED_MIN_N`). Builds the port's
kernels and records the KNN calls the main path makes: one batch-4 forward
of the full-width detector (`chip_smoke.py`'s main path: seed-0 weights,
BatchNorm statistics and inputs, switches off) and the KITTI inference CLI
on the 6 fixture val frames (batch 1, seed-0 weights). Each call then runs
on the brute arm and on the sorted arm. Every launch is held bit for bit
(indices and distances) against the plain version; each is timed (CUDA
events, mean of REPS launches after a warm-up), the sorted one beside the
share of (query, candidate) pairs it evaluates; the main path's own arm is
also profiled (torch.profiler: device us of each kernel a call launches,
the prep and the search apart). Prints a line per call, then for the
forward and for the frames the summed ms of each arm over all calls and
over the calls the threshold sends to the sorted arm, and writes
DIR/knn_sweep.json (default outputs/).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10
ARMS = ("brute", "sorted")


def kernel_us(fn, reps=REPS):
    """Device us a call of fn spends in each kernel (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key[e.key.find("knn_"):] if "knn_" in e.key else e.key
            name = name.split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + e.device_time_total / reps
    return out


def sweep_call(k, xyz, qrs):
    """One recorded call on both arms: exact, timed."""
    import torch

    from chip_smoke import cuda_ms, knn_bits
    from heterofusionrcnn_torch.ops import grouping

    b, n, p = xyz.shape[0], xyz.shape[1], qrs.shape[1]
    want = knn_bits(grouping.knn_point_plain(k, xyz, qrs))
    out = []
    for arm in ARMS:
        fn = lambda: grouping.knn_point(k, xyz, qrs, arm=arm)  # noqa: E731
        if not torch.equal(knn_bits(fn()), want):
            raise AssertionError(f"knn {arm} arm differs from the plain version "
                                 f"at {b}x{p}q x {n} k{k}")
        rec = dict(arm=arm, ms=cuda_ms(fn, REPS))
        if arm == "sorted":
            visited = torch.zeros(1, dtype=torch.int64, device=xyz.device)
            grouping.knn_sorted(k, xyz, qrs, visited=visited)
            rec["visited_share"] = int(visited) / (b * p * n)
        out.append(rec)
    same = " same set" if qrs is xyz else ""
    return dict(shape=f"{b}x{p}q x {n}{same} k{k}", b=b, n=n, p=p, k=k,
                main_arm=grouping.knn_arm(n, p), runs=out,
                main_kernel_us=kernel_us(lambda: grouping.knn_point(k, xyz, qrs)))


def summarize(name, calls):
    """Summed ms of each arm over all calls and over the calls the
    threshold sends to the sorted arm."""
    rows = {}
    for c in calls:
        for rec in c["runs"]:
            s = rows.setdefault(rec["arm"], dict(all_ms=0.0, sorted_calls_ms=0.0))
            s["all_ms"] += rec["ms"]
            if c["main_arm"] == "sorted":
                s["sorted_calls_ms"] += rec["ms"]
    print(f"{name}: summed ms per arm (all {len(calls)} calls / the calls the threshold "
          f"sends to the sorted arm)", flush=True)
    for arm, s in rows.items():
        print(f"  {arm}: {s['all_ms']:.4f} / {s['sorted_calls_ms']:.4f}", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="outputs", help="directory for knn_sweep.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("knn_sweep: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    sys.path.insert(0, ROOT)
    from chip_smoke import (BATCH, SEED, card_line, kitti_cli, ptxas_summary,
                            randomize_batchnorm, recording)
    from heterofusionrcnn_torch.inference import build_two_stage
    from heterofusionrcnn_torch.ops import conv, cropping, dispatch, grouping, nms, sampling, xconv

    report = {"card": card_line(), "torch": torch.__version__}
    print(report["card"], flush=True)
    dispatch.build_all([grouping.KNN_KERNEL, sampling.FPS_KERNEL, nms.NMS_KERNEL,
                        xconv.XCONV_KERNEL, cropping.CROP_KERNEL, conv.CONV_KERNEL,
                        conv.CONVT_KERNEL])
    report["ptxas"] = ptxas_summary(grouping.KNN_KERNEL.build_log)
    for f in report["ptxas"]:
        print("ptxas knn: " + " ".join(f"{k}={v}" for k, v in f.items()), flush=True)

    det, inputs = build_two_stage(BATCH, SEED, "cuda")
    randomize_batchnorm(det, SEED)
    with recording(("knn_point",)) as calls:
        det(*inputs)
    del det
    forward = calls["knn_point"]
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=args.out) as tmp:
        with recording(("knn_point",)) as calls:
            kitti_cli(tmp, os.path.join(tmp, "checkpoints"), [])
    frames = calls["knn_point"]

    for name, recorded in (("forward", forward), ("frames", frames)):
        out = []
        for (k, xyz, qrs), _ in recorded:
            c = sweep_call(k, xyz, qrs)
            out.append(c)
            print(f"{name} {c['shape']} (main path: {c['main_arm']}; device us " + ", ".join(
                f"{kn} {us:.1f}" for kn, us in c["main_kernel_us"].items()) + "): " + "; ".join(
                f"{r['arm']} {r['ms']:.4f}" + (f" ({r['visited_share']:.4f})"
                                                if "visited_share" in r else "")
                for r in c["runs"]), flush=True)
        report[name] = dict(calls=out, summary=summarize(name, out))

    with open(os.path.join(args.out, "knn_sweep.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
