"""The benchmark's general machinery: finding a cell's files by name,
building the program's and the reference's configurations from a
configuration file, the device and its peak memory, the metric readers,
and the result line.

A cell (an entry of `workloads` in BENCHMARK.json) names a configuration
(`hfbench/configs/<file>`), a traffic mix (`hfbench/traffic/<name>.json`)
and is described by `hfbench/workloads/<cell>.json`, which names its entry
loop (`hfbench/entries/<kind>.py`) and the limits of its comparison. Each
metric is read by `hfbench/metrics/<metric>.py`, or by the reader of the
quantity before its first dot.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# Top-level module names that no run may hold once its window has closed:
# JAX, its libraries, the JAX package and the repository's JAX-era scripts.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "heterofusionrcnn_tpu",
                     "__graft_entry__", "bench", "chip_smoke", "tools")
PROGRAM = "heterofusionrcnn_torch"


class BenchError(RuntimeError):
    """A run that cannot measure (no card, a missing file, a drifted
    configuration): it exits non-zero and prints no result."""


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(REPO, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """Everything one cell's run reads: its BENCHMARK.json entry, its
    workload file, its configuration file and its traffic file."""

    name: str
    entry: dict
    spec: dict
    config: dict
    traffic: dict
    chips: int

    @property
    def kind(self) -> str:
        return self.spec["entry"]


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json and its files; a workload file
    that disagrees with BENCHMARK.json on the configuration, traffic or
    chips is refused."""
    bench = bench or benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    spec = load_json(os.path.join(HERE, "workloads", name + ".json"))
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise BenchError(f"workloads/{name}.json has {key} {spec[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    config = load_json(os.path.join(REPO, configs[entry["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", entry["traffic"] + ".json"))
    return Cell(name, entry, spec, config, traffic, entry["chips"])


def cell_metrics(cell: Cell, trace: bool, bench: Optional[dict] = None) -> List[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics with
    `--trace 0`, its per-layer metrics with `--trace 1` (those whose
    `workloads` list it, or every one without the key)."""
    bench = bench or benchmark()
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell.name in m.get("workloads", [cell.name])]


def reader(metric: str):
    """The reader module of `metric`: hfbench/metrics/<metric>.py, or where
    there is none, the reader of the quantity before its first dot
    (`mfu.train` and `mfu.serve` share `metrics/mfu.py`). Its layer and the
    metric it moves are BENCHMARK.json's."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", metric.split(".", 1)[0] + ".py")
    if not os.path.exists(path):
        raise BenchError(f"no reader metrics/{metric}.py")
    name = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(f"hfbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_class(kind: str):
    """The entry loop `hfbench/entries/<kind>.py`'s `Entry`."""
    return importlib.import_module(f"hfbench.entries.{kind}").Entry


# ------------------------------------------------------------ configurations

def _apply(obj, dotted: str, value) -> None:
    """Set a dotted key of a configuration (a number in it indexes a list)."""
    *path, last = dotted.split(".")
    for p in path:
        obj = obj[int(p)] if p.isdigit() else getattr(obj, p)
    if last.isdigit():
        obj[int(last)] = value
    else:
        setattr(obj, last, value)


def _plain(obj):
    """A configuration as JSON would hold it (tuples as lists)."""
    return json.loads(json.dumps(dataclasses.asdict(obj)))


def program_configs(config: dict) -> Dict[str, Any]:
    """The program's PipelineConfig of each stage of a configuration file:
    its preset, each preset function called into a key (`call`), then each
    key set (`set`). Refused unless it equals the frozen `pipeline` dict
    the file holds, so a change to a preset cannot move the yardstick."""
    from heterofusionrcnn_torch.configs import presets

    out = {}
    for stage, recipe in config["port"].items():
        cfg = getattr(presets, recipe["preset"])()
        for key, fn in recipe.get("call", {}).items():
            _apply(cfg, key, getattr(presets, fn)())
        for key, value in recipe.get("set", {}).items():
            _apply(cfg, key, value)
        if _plain(cfg) != config["pipeline"][stage]:
            raise BenchError(f"the program's {stage} configuration differs from the frozen one "
                             f"in {config['name']}")
        out[stage] = cfg
    return out


def reference_configs(config: dict) -> Dict[str, Any]:
    """The reference's PipelineConfig of each stage, from the frozen dict."""
    from hfbench.reference.config import PipelineConfig, _from_dict

    return {stage: _from_dict(PipelineConfig, d) for stage, d in config["pipeline"].items()}


# ------------------------------------------------------------ the device

def require_devices(chips: int):
    """The card(s) a cell asks for; no fallback to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: this benchmark measures the port on its GPU")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell asks for {chips} GPUs, {torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def set_precision(tf32: bool) -> None:
    """Float32 products in full float32 (the program's
    `inference.exact_float32`, which serving and training call), or with
    TF32 switched on for matmuls and cuDNN: the control."""
    import torch

    from heterofusionrcnn_torch.inference import exact_float32

    exact_float32()
    if tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True


def device_info(device, memory_peak: int, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": memory_peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(memory_peak)}


def forbidden_loaded() -> List[str]:
    """Top-level names (the part before the first dot, whole) of loaded
    modules that no run may hold."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def clock() -> float:
    return time.perf_counter()


class Phases:
    """Seconds of each phase of a run's set-up, printed to standard error."""

    def __init__(self, t0: float):
        self.t = t0

    def __call__(self, name: str) -> None:
        now = clock()
        print(f"setup {name} {now - self.t:.3f} s", file=sys.stderr, flush=True)
        self.t = now
