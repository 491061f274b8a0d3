"""Step 13 of `chip_smoke.py` (data parallelism, `dp_phase`) run several
times on the card, from this tree or another one (for instance a `git
archive` of a parent commit unpacked under _archive/), and each run's
outcome counted: how many of n runs pass the step's checks, the gloo
ranks' image-branch gradient gate among them. Card only.

    python tools/dp_gate_runs.py [--tree DIR] [--runs 5] [--out DIR]

Each run prints what the step prints (the resolutions it measures, each
rank's differences); the last lines give the card's name and power limit,
each run's pass or its failure's message, and the count.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="the checkout whose chip_smoke.py and package run (default: this one)")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default="outputs/dp_gate_runs")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)  # spawned ranks inherit it: they import the tree's modules

    import torch

    if not torch.cuda.is_available():
        print("dp_gate_runs: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    chip_smoke = importlib.import_module("chip_smoke")
    from heterofusionrcnn_torch.ops import dispatch

    if not chip_smoke.__file__.startswith(tree):
        raise RuntimeError(f"chip_smoke imported from {chip_smoke.__file__}, not {tree}")
    kernels = []
    for name in ("conv", "cropping", "grouping", "nms", "sampling", "xconv"):
        module = importlib.import_module(f"heterofusionrcnn_torch.ops.{name}")
        kernels += [k for k in vars(module).values() if isinstance(k, dispatch.CudaKernel)]
    dispatch.build_all(kernels)
    torch.set_grad_enabled(False)
    outcomes = []
    for i in range(args.runs):
        t0 = time.perf_counter()
        try:
            chip_smoke.dp_phase(args.out)
        except AssertionError as exc:
            outcomes.append(f"run {i + 1}: FAIL ({exc})")
        else:
            outcomes.append(f"run {i + 1}: pass")
        outcomes[-1] += f", {time.perf_counter() - t0:.1f} s"
        print(outcomes[-1], flush=True)
    print(chip_smoke.card_line())
    print(f"{tree}: " + "; ".join(outcomes))
    print(f"step 13 passed {sum(o.split(': ')[1].startswith('pass') for o in outcomes)} of "
          f"{args.runs} runs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
