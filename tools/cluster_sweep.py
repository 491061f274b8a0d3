#!/usr/bin/env python3
"""Cluster size and block size of the FPS and NMS kernels, on one NVIDIA card.

    python tools/cluster_sweep.py [--out DIR]

Builds `heterofusionrcnn_torch/ops/csrc/fps.cu` and `nms.cu`, prints
ptxas's registers and spills per kernel, then launches each kernel on
seeded random inputs at the main path's shapes (FPS 4 x 16384 -> 4096,
4 x 4096 -> 1024, 4 x 1024 -> 256, 400 x 512 -> 128; NMS 4 x 9000 -> 100 at
0.8 and 4 x 100 -> 100 at 0.01 with a mask) with each set on a cluster of
1, 2, 4, 8 and 16 CTAs of 64 to 1024 threads (powers of two up to one
item a thread; at most 32 items a thread). Every launch is held bit for bit against the plain
version; each is timed (CUDA events, mean of REPS launches after a
warm-up) and printed with its time per iteration or keep step, beside the
cluster size and threads the wrapper's plan picks. Writes DIR/cluster_sweep.json
(default outputs/).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 5
FPS_SHAPES = [(4, 16384, 4096), (4, 4096, 1024), (4, 1024, 256), (400, 512, 128)]
NMS_SHAPES = [(4, 9000, 100, 0.8, False), (4, 100, 100, 0.01, True)]


def thread_options(n: int, c: int):
    """Threads a CTA to try for sets of n items on clusters of c: 64 to 1024
    in powers of two, up to one item a thread, at most 32 items a thread."""
    share = -(-n // c)
    full = min(1024, 32 * -(-share // 32))
    return [t for t in (64, 128, 256, 512, 1024) if t < full and share <= 32 * t] + [full]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="outputs", help="directory for cluster_sweep.json")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("cluster_sweep: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, cuda_ms, ptxas_summary
    from heterofusionrcnn_torch.ops import dispatch, nms, sampling

    report = {"card": card_line(), "fps": [], "nms": []}
    print(report["card"], flush=True)
    dispatch.build_all([sampling.FPS_KERNEL, nms.NMS_KERNEL])
    report["ptxas"] = {k.name: ptxas_summary(k.build_log)
                       for k in (sampling.FPS_KERNEL, nms.NMS_KERNEL)}
    for name, fns in report["ptxas"].items():
        for f in fns:
            print(f"ptxas {name}: " + " ".join(f"{k}={v}" for k, v in f.items()), flush=True)
    sms = dispatch.sm_count(torch.device("cuda"))
    rng = np.random.default_rng(0)

    for b, n, npoint in FPS_SHAPES:
        xyz = torch.from_numpy(rng.uniform(-40, 40, (b, n, 3)).astype(np.float32)).cuda()
        want = sampling.farthest_point_sample_plain(xyz, npoint)
        plan = sampling.fps_plan(b, n, sms, lambda c, t: sampling.fps_clusters(n, c, t) > 0)
        for c in (1, 2, 4, 8, 16):
            for threads in thread_options(n, c):
                fit = sampling.fps_clusters(n, c, threads)
                row = dict(shape=f"{b}x{n}->{npoint}", cluster=c, threads=threads,
                           fit=fit, plan=(c, threads) == plan)
                if fit:
                    got = sampling._fps_kernel(xyz, npoint, c, threads)
                    row["exact"] = bool(torch.equal(got, want))
                    row["ms"] = cuda_ms(lambda: sampling._fps_kernel(xyz, npoint, c, threads), REPS)
                    row["us_per_iteration"] = row["ms"] * 1e3 / max(npoint - 1, 1)
                report["fps"].append(row)
                print(f"fps {row}", flush=True)

    for b, n, keep, thresh, masked in NMS_SHAPES:
        cx, cz = rng.uniform(-40, 40, (2, b, n))
        hl, hw = rng.uniform(0.5, 2.5, (b, n)), rng.uniform(0.3, 1.5, (b, n))
        ry = rng.uniform(-np.pi, np.pi, (b, n))
        boxes = np.stack([cx - hl, cz - hw, cx + hl, cz + hw, ry], -1).astype(np.float32)
        boxes = torch.from_numpy(boxes).cuda()
        scores = torch.from_numpy(rng.uniform(0, 1, (b, n)).astype(np.float32)).cuda()
        valid = torch.from_numpy(rng.uniform(size=(b, n)) > 0.3).cuda() if masked else None
        want = nms.oriented_nms_plain(boxes, scores, thresh, keep, valid)
        plan = nms.nms_plan(b, n, sms, lambda c, t: nms.nms_clusters(n, c, t) > 0)
        for c, threads in ((c, t) for c in (1, 2, 4, 8, 16) for t in thread_options(n, c)):
            fit = nms.nms_clusters(n, c, threads)
            row = dict(shape=f"{b}x{n}->{keep}@{thresh}", cluster=c, threads=threads, fit=fit,
                       plan=(c, threads) == plan)
            if fit:
                got = nms._nms_kernel(boxes, scores, thresh, keep, valid, c, threads)
                row["exact"] = bool(torch.equal(got, want))
                row["ms"] = cuda_ms(
                    lambda: nms._nms_kernel(boxes, scores, thresh, keep, valid, c, threads), REPS)
                row["us_per_step"] = row["ms"] * 1e3 / keep
            report["nms"].append(row)
            print(f"nms {row}", flush=True)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "cluster_sweep.json"), "w") as f:
        json.dump(report, f, indent=1)
    bad = [r for r in report["fps"] + report["nms"] if r["fit"] and not r["exact"]]
    if bad:
        print(f"cluster_sweep: {len(bad)} launches differ from the plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
