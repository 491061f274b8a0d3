#!/usr/bin/env python3
"""The batch-4 forward, timed in turns on two trees, on one NVIDIA card.

    python tools/forward_turns.py TREE_A TREE_B [--pairs 10] [--out FILE]
        [--dtype float32|bfloat16] [--switches off|on]

TREE_A and TREE_B are checkouts of the repo (for example `git archive`s of
a parent commit and of its change). Each turn is a fresh process run on
one tree: it imports that tree's `chip_smoke.py` and port, builds the
full-width two-stage detector at batch 4 with `chip_smoke.py`'s seed-0
weights, BatchNorm statistics and inputs, in `--dtype` (its
`compute_dtype`; float32 is cell A, bfloat16 cell G) with the conv and
crop kernel switches `--switches` (default off, the JAX package's
default; the tree's kernels build at first use, once per tree), runs one
forward to
warm up, times the forward three times with `chip_smoke.cuda_ms` (CUDA
events, mean of its ITERS forwards) and keeps their median, then takes
the forward's device time once (`chip_smoke.profile_forward`). Pairs
alternate which tree runs first (A B, B A, ...). Prints a line per turn,
then per tree the median and quartiles of its turns' ms and device ms
and the pairs each tree won; writes all turns to FILE (default
outputs/forward_turns.json).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def one_turn(tree: str, dtype: str, switches: bool) -> dict:
    """One turn in this process, on `tree`."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as cs
    from heterofusionrcnn_torch.inference import build_two_stage

    torch.set_grad_enabled(False)
    det, inputs = build_two_stage(cs.BATCH, cs.SEED, "cuda", conv_kernels=switches,
                                  crop_kernel=switches, compute_dtype=dtype)
    cs.randomize_batchnorm(det, cs.SEED)
    det(*inputs)
    torch.cuda.synchronize()
    runs = [cs.cuda_ms(lambda: det(*inputs), cs.ITERS) for _ in range(3)]
    return dict(ms=statistics.median(runs), runs=runs,
                device_ms=cs.profile_forward(det, inputs)["device_busy_ms"])


def quartiles(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return dict(median=statistics.median(xs), q1=q[0], q3=q[2])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="TREE_A TREE_B (or --one TREE)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", default="outputs/forward_turns.json")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--switches", choices=("off", "on"), default="off")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_turn(args.trees[0], args.dtype, args.switches == "on")), flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees")

    turns = []
    for i in range(args.pairs):
        order = args.trees if i % 2 == 0 else args.trees[::-1]
        pair = {}
        for tree in order:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree,
                                  "--dtype", args.dtype, "--switches", args.switches],
                                 capture_output=True, text=True, timeout=600)
            if out.returncode:
                sys.stderr.write(out.stdout + out.stderr)
                return out.returncode
            t = dict(json.loads(out.stdout.strip().splitlines()[-1]), tree=tree, pair=i)
            turns.append(t)
            pair[tree] = t["ms"]
            print(f"pair {i} {tree}: {t['ms']:.4f} ms (runs "
                  + " ".join(f"{r:.4f}" for r in t["runs"]) + f"), device {t['device_ms']:.4f}",
                  flush=True)
        a, b = (pair[t] for t in args.trees)
        winner = None if a == b else args.trees[0] if a < b else args.trees[1]  # ties: neither
        turns[-1]["winner"] = turns[-2]["winner"] = winner

    summary = {}
    for tree in args.trees:
        mine = [t for t in turns if t["tree"] == tree]
        summary[tree] = dict(ms=quartiles([t["ms"] for t in mine]),
                             device_ms=quartiles([t["device_ms"] for t in mine]),
                             pairs_won=sum(t["winner"] == tree for t in mine))
        s = summary[tree]
        print(f"{tree}: ms median {s['ms']['median']:.4f} (quartiles {s['ms']['q1']:.4f} "
              f"{s['ms']['q3']:.4f}), device ms median {s['device_ms']['median']:.4f} "
              f"(quartiles {s['device_ms']['q1']:.4f} {s['device_ms']['q3']:.4f}), "
              f"pairs won {s['pairs_won']} of {args.pairs}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(turns=turns, summary=summary, dtype=args.dtype, switches=args.switches),
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
