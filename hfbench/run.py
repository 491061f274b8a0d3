"""Run one cell of the benchmark once on the GPU and print its result.

    python3 hfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the cell's inputs and weights from the seed, the program built and
warmed on every staged batch), then a window of `--seconds` that drives the
program's entry back to back, then the check against the reference. The
last line of standard output is the result: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1` a
`breakdown`, and last `checks`, each number compared with its limit; the
same numbers close standard error. A run that cannot measure (no GPU,
fewer GPUs than the cell asks for, a fixture or configuration that
differs from the recorded one, JAX loaded) exits non-zero and prints no
result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel caches of libraries the program may use, at fixed paths inside
# the checkout (the program's own nvcc builds go to its ops/_build/).
CACHES = {"TORCH_EXTENSIONS_DIR": os.path.join(REPO, ".bench_cache", "torch_extensions"),
          "TRITON_CACHE_DIR": os.path.join(REPO, ".bench_cache", "triton")}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json's workloads")
    p.add_argument("--seed", type=int, required=True, help="inputs and weights")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: per-layer metrics from a traced run")
    return p.parse_args(argv)


def run(args, device=None, control=False, cell=None, t0=T0) -> dict:
    """One run of a cell; returns the result dict. `device`, `control` and
    `cell` serve the tests and the control (a CPU run at small size, the
    program with TF32 on, a cell built from other files)."""
    import torch

    from hfbench import harness, judge
    from hfbench.trace import breakdown, busy_and_gaps

    harness.Phases(t0)("imports")
    bench = harness.benchmark()
    cell = cell or harness.find_cell(args.workload, bench)
    if device is None:
        device = harness.require_devices(cell.chips)
    entry = harness.entry_class(cell.kind)(cell, args.seed, device, bool(args.trace), control)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    entry.setup()
    # The set-up's objects leave the collector's generations, so that its
    # collections in the window scan only what the window allocates.
    gc.collect()
    gc.freeze()
    setup_s = harness.clock() - t0
    window = entry.window(args.seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    entry.release()
    gc.unfreeze()
    numbers, limits = entry.judge()
    correct = judge.passes(numbers, limits)

    cfgs = harness.reference_configs(cell.config)
    record = {"window": window, "setup_s": setup_s, "memory_peak_bytes": peak,
              "model": cell.spec.get("model", "rpn"), "kind": cell.kind, "configs": cfgs,
              "num_classes": len(cell.config["cluster_sizes"]),
              "compute_dtype": cell.config["compute_dtype"],
              "traced_iterations": cell.traffic["trace_iterations"]}
    metrics = {}
    for m in harness.cell_metrics(cell, bool(args.trace), bench):
        value = harness.reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    forbidden = harness.forbidden_loaded()
    if forbidden:
        raise harness.BenchError(f"modules that no run may load are loaded: {forbidden}")
    result = {"correct": correct, "attempted": window["iterations"], "failed": 0,
              "metrics": metrics, "device": harness.device_info(device, peak, cell.chips)}
    if args.trace and window["trace"] is not None:
        busy, _ = busy_and_gaps(window["trace"])
        w0, w1 = window["trace"]["window"]
        result["device"].update(busy_s=busy * 1e-6, window_s=(w1 - w0) * 1e-6)
        result["breakdown"] = breakdown(window["trace"])
    result["checks"] = judge.limits_line(numbers, limits)
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, REPO)
    for key, path in CACHES.items():
        os.environ[key] = path
    from hfbench import harness
    from hfbench.inputs.kitti import FixtureMismatch

    try:
        result = run(args)
    except (harness.BenchError, FixtureMismatch) as e:
        print(f"hfbench: {e}", file=sys.stderr)
        return 2
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
