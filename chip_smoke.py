#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the four hand-written kernels (`heterofusionrcnn_torch/ops/csrc`,
   one nvcc per source, all at once).
3. Drives the main path: full-width `rpn_multiclass` -> `rcnn_multiclass`
   two-stage inference (16384 points, 360x1200 images) at batch 4 with
   random weights and BatchNorm statistics from seed 0. Every launch count
   is set to 0 just before one forward and read just after; each of the
   four kernels must have launched. The forward is then timed over 5
   batches with CUDA events and profiled once (device time by kernel name,
   device busy share).
4. Calls each kernel's wrapper again on the exact inputs that forward gave
   it (recorded in a separate, uncounted forward, one record per launch of
   the counted one) and holds the result against the kernel's plain
   PyTorch version: indices bit-exact for KNN, FPS and NMS,
   |kernel - plain| <= 1e-4 + 1e-4 |plain| for the fused XConv. Times the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call (`library_ms`, a yardstick the port never calls);
   computes each kernel's bound from its inputs, and FPS's latency floor
   (npoint times the per-iteration time of the FPS kernel on 1024 points,
   one a thread) for the report file.
5. Checks the outputs: finite, expected shapes, sane counts, and the same
   detector at small width on the card agreeing with its CPU run.

Prints a {"kernels": [...]} JSON line, then the result as its last line,
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
CUDA is unavailable, the package is missing or any check fails. Details go
to --out (default outputs/) as chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM FP32 outside the tensor cores
XCONV_RTOL = XCONV_ATOL = 1e-4
BATCH = 4                      # frames per forward on the main path
SEED = 0                       # weights, BatchNorm statistics and inputs
ITERS = 5                      # forwards timed
REPS = 10                      # kernel calls timed per main-path call
# One rotated IoU in nms.cu: two clipping passes of 4 edges x 4 half-planes
# at ~30 FP32 and compare operations each, ~10 more per half-plane for the
# collinear test of the second pass, ~10 for the IoU itself.
NMS_OPS_PER_IOU = 2 * 16 * 30 + 16 * 10 + 10

TPU_KERNELS = {
    "knn": "heterofusionrcnn_tpu/ops/pallas_knn.py:356 (_knn_pallas_sorted), :472 (knn_pallas brute arm)",
    "fps": "heterofusionrcnn_tpu/ops/pallas_fps.py:116 (farthest_point_sample_pallas)",
    "nms": "heterofusionrcnn_tpu/ops/pallas_nms.py:138 (oriented_nms_pallas)",
    "xconv": "heterofusionrcnn_tpu/ops/pallas_xconv.py:263 (fused_xconv)",
}
# The op each kernel's wrapper is reached through on the main path; each
# call of it launches the kernel once.
KERNEL_OPS = {"knn": "knn_point", "fps": "farthest_point_sample",
              "nms": "oriented_nms", "xconv": "fused_xconv"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Recorder:
    """Wraps an op function and keeps the arguments of every call."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.fn(*args, **kwargs)


def randomize_batchnorm(module, seed):
    """Seeded BatchNorm scales, shifts and running statistics, so every
    folded BN shift in the kernels is non-zero and every scale differs
    from 1 (a fresh init folds to shift 0, scale ~1)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            c = m.num_features
            for t, lo, hi in ((m.weight, 0.5, 1.5), (m.running_var, 0.5, 2.0)):
                t.copy_(lo + (hi - lo) * torch.rand(c, generator=gen))
            for t in (m.bias, m.running_mean):
                t.copy_(0.1 * torch.randn(c, generator=gen))
    return module


def record_kernel_inputs(det, inputs):
    """One uncounted forward with the kernel ops wrapped, so the checks run
    on the inputs the main path gives each kernel."""
    from heterofusionrcnn_torch.models.extractors import pointcnn
    from heterofusionrcnn_torch.ops import nms

    patches = {
        (pointcnn, "knn_point"): Recorder(pointcnn.knn_point),
        (pointcnn, "farthest_point_sample"): Recorder(pointcnn.farthest_point_sample),
        (pointcnn, "fused_xconv"): Recorder(pointcnn.fused_xconv),
        (nms, "oriented_nms"): Recorder(nms.oriented_nms),
    }
    for (mod, name), rec in patches.items():
        setattr(mod, name, rec)
    try:
        det(*inputs)
    finally:
        for (mod, name), rec in patches.items():
            setattr(mod, name, rec.fn)
    return {name: rec.calls for (_, name), rec in patches.items()}


def nms_iou_count(boxes, scores, thresh, keep, valid):
    """IoUs the greedy loop needs on this data: at each keep step, one per
    box still alive (valid, not kept, not suppressed by an earlier keep)."""
    import torch

    from heterofusionrcnn_torch.core.rotated_iou import bev_iou

    total = 0
    for f in range(boxes.shape[0]):
        alive = torch.ones(boxes.shape[1], dtype=torch.bool, device=boxes.device)
        if valid is not None:
            alive &= valid[f].bool()
        for i in keep[f].tolist():
            if i < 0:
                break
            total += int(alive.sum()) - 1
            alive &= ~(bev_iou(boxes[f, i:i + 1], boxes[f])[0] > thresh)
            alive[i] = False
    return total


def check_kernels(calls, reps):
    """Kernel vs plain on every recorded call; times and bounds summed over
    the calls of one forward."""
    import torch

    from heterofusionrcnn_torch.ops import grouping, nms, sampling, xconv

    rows = {}

    def row(name, source):
        rows[name] = dict(name=name, route="cuda", source=source,
                          replaces=TPU_KERNELS[name], launches=0, max_abs_err=0.0,
                          ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by="operations",
                          library_ms=None, calls=[])
        return rows[name]

    def add_bound(r, nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        r["_bytes_ms"] = r.get("_bytes_ms", 0.0) + t_bytes
        r["_ops_ms"] = r.get("_ops_ms", 0.0) + t_ops
        r["bound_ms"] += max(t_bytes, t_ops)

    # KNN: 8 FP32 operations per (query, candidate) pair.
    r = row("knn", "heterofusionrcnn_torch/ops/csrc/knn.cu")
    r["library_ms"] = 0.0
    for (k, xyz, qrs), _ in calls["knn_point"]:
        d, i = grouping.knn_point(k, xyz, qrs)
        pd, pi = grouping.knn_point_plain(k, xyz, qrs)
        if not torch.equal(i, pi):
            raise AssertionError(f"knn indices differ at k={k} {tuple(xyz.shape)} {tuple(qrs.shape)}")
        r["max_abs_err"] = max(r["max_abs_err"], float((d - pd).abs().max()))
        ms = cuda_ms(lambda: grouping.knn_point(k, xyz, qrs), reps)
        pms = cuda_ms(lambda: grouping.knn_point_plain(k, xyz, qrs), 1)
        lms = cuda_ms(lambda: torch.topk(torch.cdist(qrs, xyz), k, dim=-1, largest=False), reps)
        b, n, p = xyz.shape[0], xyz.shape[1], qrs.shape[1]
        add_bound(r, (b * n * 3 + b * p * 3) * 4 + b * p * k * 8, 8.0 * b * p * n)
        r["ms"] += ms
        r["plain_ms"] += pms
        r["library_ms"] += lms
        r["calls"].append(dict(shape=f"{b}x{p}q x {n} k{k}", ms=ms, plain_ms=pms, library_ms=lms))

    # FPS: 9 FP32 operations (distance + min) per point per iteration. Its
    # real floor is latency, npoint dependent block-wide argmaxes: one
    # iteration is timed on 1024 points (one a thread, B=1, npoint=1024).
    r = row("fps", "heterofusionrcnn_torch/ops/csrc/fps.cu")
    probe = torch.rand((1, 1024, 3), generator=torch.Generator().manual_seed(SEED)).cuda()
    r["iteration_us"] = cuda_ms(lambda: sampling.farthest_point_sample(probe, 1024), reps) / 1024 * 1e3
    r["latency_ms"] = 0.0
    for (xyz, npoint), _ in calls["farthest_point_sample"]:
        got = sampling.farthest_point_sample(xyz, npoint)
        if not torch.equal(got, sampling.farthest_point_sample_plain(xyz, npoint)):
            raise AssertionError(f"fps picks differ at {tuple(xyz.shape)} -> {npoint}")
        ms = cuda_ms(lambda: sampling.farthest_point_sample(xyz, npoint), reps)
        pms = cuda_ms(lambda: sampling.farthest_point_sample_plain(xyz, npoint), 1)
        b, n = xyz.shape[:2]
        add_bound(r, b * n * 12 + b * npoint * 4, 9.0 * b * n * npoint)
        r["latency_ms"] += npoint * r["iteration_us"] * 1e-3
        r["ms"] += ms
        r["plain_ms"] += pms
        r["calls"].append(dict(shape=f"{b}x{n}->{npoint}", ms=ms, plain_ms=pms))

    # NMS: NMS_OPS_PER_IOU per rotated IoU, counted for the IoUs this data
    # needs.
    r = row("nms", "heterofusionrcnn_torch/ops/csrc/nms.cu")
    for a, kw in calls["oriented_nms"]:
        bev, scores, thresh, keep = a[:4]
        valid = a[4] if len(a) > 4 else kw.get("valid_mask")
        got, _ = nms.oriented_nms(bev, scores, thresh, keep, valid)
        want = nms.oriented_nms_plain(bev, scores, thresh, keep, valid)
        if not torch.equal(got, want):
            raise AssertionError(f"nms keep lists differ at {tuple(bev.shape)} -> {keep}")
        ms = cuda_ms(lambda: nms.oriented_nms(bev, scores, thresh, keep, valid), reps)
        pms = cuda_ms(lambda: nms.oriented_nms_plain(bev, scores, thresh, keep, valid), 1)
        b, n = bev.shape[:2]
        ious = nms_iou_count(bev, scores, thresh, got, valid)
        add_bound(r, b * n * 25 + b * keep * 4, float(NMS_OPS_PER_IOU * ious))
        r["ms"] += ms
        r["plain_ms"] += pms
        r["calls"].append(dict(shape=f"{b}x{n}->{keep}@{thresh}", ms=ms, plain_ms=pms, ious=ious))

    # Fused XConv: FLOPs of lift-1, lift-2, X-net, X @ in and the composed
    # separable conv; bytes of points, queries, indices, features, weights
    # and the output.
    r = row("xconv", "heterofusionrcnn_torch/ops/csrc/xconv.cu")
    for (pts, fts, qrs, idx, w), _ in calls["fused_xconv"]:
        got = xconv.fused_xconv(pts, fts, qrs, idx, w)
        want = xconv.fused_xconv_plain(pts, fts, qrs, idx, w)
        err = (got - want).abs()
        if not bool((err <= XCONV_ATOL + XCONV_RTOL * want.abs()).all()):
            raise AssertionError(f"xconv differs by {float(err.max())} at {tuple(idx.shape)}")
        r["max_abs_err"] = max(r["max_abs_err"], float(err.max()))
        ms = cuda_ms(lambda: xconv.fused_xconv(pts, fts, qrs, idx, w), reps)
        pms = cuda_ms(lambda: xconv.fused_xconv_plain(pts, fts, qrs, idx, w), 1)
        b, n = pts.shape[:2]
        _, p, k = idx.shape
        cf, cin, d = w.w1.shape[1], w.wc.shape[1], w.wc.shape[2]
        cp = cin - cf
        per_q = k * (2 * 3 * cf + 2 * cf * cf + 2 * k * cin + 2 * cin * d)
        if w.with_x:
            per_q += 2 * 3 * k * k * k + 2 * 2 * k * k * k
        wbytes = 4 * sum(t.numel() for t in vars(w).values() if t is not None)
        nbytes = 4 * (b * n * (3 + cp) + b * p * (3 + k + d)) + wbytes
        add_bound(r, nbytes, float(b * p * per_q))
        r["ms"] += ms
        r["plain_ms"] += pms
        r["calls"].append(dict(shape=f"{b}x{p} K{k} Cf{cf} Cin{cin} D{d}", ms=ms, plain_ms=pms))

    for r in rows.values():
        r["bound_by"] = "bytes" if r.pop("_bytes_ms") > r.pop("_ops_ms") else "operations"
    return rows


def profile_forward(det, inputs, top: int = 15):
    """One forward under torch.profiler: device time by kernel name (the
    device-side events only, so nothing is counted twice) and the device's
    busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        det(*inputs)
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    return {
        "device_busy_ms": sum(r[2] for r in rows),
        "top": [{"name": k[:120], "count": c, "device_ms": ms} for k, c, ms in rows[:top]],
    }


def small_width_agrees(seed):
    """The detector at `*_unittest` width: card run vs CPU run (plain
    versions) with the same weights and inputs."""
    import torch

    from heterofusionrcnn_torch.configs.presets import rcnn_unittest, rpn_unittest
    from heterofusionrcnn_torch.inference import build_two_stage

    det, inputs = build_two_stage(2, seed, "cpu", rpn_unittest(), rcnn_unittest())
    randomize_batchnorm(det, seed)
    want = det(*inputs)
    got = det.to("cuda")(*(t.to("cuda") for t in inputs))
    ok = torch.equal(got["num_final"].cpu(), want["num_final"])
    for key in ("final_boxes", "final_scores"):
        ok = ok and torch.allclose(got[key].cpu(), want[key], rtol=1e-3, atol=1e-3)
    return bool(ok), {k: v.cpu().tolist() for k, v in got.items() if k == "num_final"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="outputs", help="directory for chip_smoke.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from heterofusionrcnn_torch.inference import build_two_stage
        from heterofusionrcnn_torch.ops import dispatch, grouping, nms, sampling, xconv
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2

    report = {"card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda}
    print(report["card"], flush=True)

    kernels = {"knn": grouping.KNN_KERNEL, "fps": sampling.FPS_KERNEL,
               "nms": nms.NMS_KERNEL, "xconv": xconv.XCONV_KERNEL}
    t0 = time.perf_counter()
    dispatch.build_all(kernels.values())
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {k: kern.build_log for k, kern in kernels.items()}
    print(f"built {len(kernels)} kernels in {report['build_s']:.1f} s", flush=True)

    det, inputs = build_two_stage(BATCH, SEED, "cuda")
    randomize_batchnorm(det, SEED)
    calls = record_kernel_inputs(det, inputs)
    torch.cuda.synchronize()

    # The main path, counted: one forward between zeroing and reading.
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = det(*inputs)
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}
    report["launches_per_forward"] = launches
    report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    recorded = {name: len(calls[op]) for name, op in KERNEL_OPS.items()}
    if recorded != launches:
        raise AssertionError(f"recorded kernel calls {recorded} != main-path launches {launches}")

    b = BATCH
    boxes, scores, num = out["final_boxes"], out["final_scores"], out["num_final"]
    if boxes.shape != (b, 100, 7) or scores.shape != (b, 100) or num.shape != (b,):
        raise AssertionError(f"unexpected output shapes {boxes.shape} {scores.shape} {num.shape}")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("non-finite outputs")
    if not bool(((num >= 1) & (num <= 100)).all()):
        raise AssertionError(f"final box counts out of range: {num.tolist()}")
    report["num_final"] = num.tolist()

    ms = cuda_ms(lambda: det(*inputs), ITERS)
    report["fused_ms_per_batch"] = ms
    report["frames_per_s"] = b / ms * 1e3
    print(f"fused two-stage inference: {ms:.2f} ms per batch of {b}", flush=True)
    report["profile"] = profile_forward(det, inputs)
    report["device_busy_share"] = report["profile"]["device_busy_ms"] / ms

    rows = check_kernels(calls, REPS)
    for name, r in rows.items():
        r["launches"] = launches[name]
    report["kernels"] = rows

    agree, small = small_width_agrees(SEED)
    report["small_width_agrees"] = agree
    report["small_width"] = small
    if not agree:
        raise AssertionError("small-width card run disagrees with the CPU run")

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
