"""The comparison numbers of one cell over many seeds, in one process:
the program's own (sound runs), with `--control` the program with TF32
switched on for its matmuls and convolutions (the control that the limits
must fail), or with `--fault NAME` a fault of `hfbench/faults.py` planted.
`PERF.md` sets each limit from these readings.

    python3 hfbench/readings.py --workload <cell> --seeds 11 12 13 [--control] [--fault F]

One JSON line a seed: the seed, whether it was the control, `correct`
and each number beside its limit.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seeds, control: bool, seconds: float, fault: str = ""):
    """Yield (seed, result) of a short run of `workload` for each seed,
    with `fault` (a name of `hfbench/faults.py`) planted if given."""
    from hfbench import faults, harness
    from hfbench.run import run

    cell = harness.find_cell(workload)
    patcher = faults.Patcher()
    if fault:
        faults.FAULTS[cell.kind][fault](patcher, cell.spec.get("model"))
    try:
        for seed in seeds:
            args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=0)
            yield seed, run(args, control=control, t0=harness.clock())
    finally:
        patcher.undo()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true", help="the program with TF32 on")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default="", help="a fault of hfbench/faults.py to plant")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    for seed, res in readings(args.workload, args.seeds, args.control, args.seconds, args.fault):
        print(json.dumps({"seed": seed, "control": args.control, "fault": args.fault,
                          "correct": res["correct"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
