"""KITTI AP evaluation through the repo's native C++ evaluator (parity with
heterofusionrcnn_tpu/runtime/native_eval.py `run_kitti_native_eval` and
`run_kitti_native_eval_async`).

The evaluator's source, `native/kitti_eval/kitti_eval.cpp`, is shared with
the JAX package. It is compiled here with `g++` at first use into
`runtime/_build/` (listed in `.gitignore`), under a name that hashes the
source, so an edited source rebuilds; a binary committed beside the source
is not used.

`run_kitti_native_eval_async` runs the evaluator from a child process
started by `spawn`: this module imports only the standard library, so the
child starts cheaply and never inherits the parent's CUDA context.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parents[2] / "native" / "kitti_eval" / "kitti_eval.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
_FLAGS = ["-O2", "-std=c++17"]


def ensure_built(source: Path = SOURCE) -> str:
    """Path of the evaluator binary, compiled if missing."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    binary = BUILD_DIR / f"kitti_eval-{digest}"
    if not binary.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = binary.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(source)], check=True,
                       capture_output=True)
        os.replace(tmp, binary)
    return str(binary)


def run_kitti_native_eval(gt_dir: str, det_dir: str, out_dir: Optional[str] = None,
                          low_iou: bool = False) -> dict:
    """Run the evaluator and parse its AP lines.

    low_iou selects the relaxed BEV/3D thresholds (0.5 car, 0.25 ped/cyc).
    Returns {"<class>_<metric>": (easy, moderate, hard), ...} in percent.
    """
    binary = ensure_built()
    out_dir = out_dir or det_dir
    os.makedirs(out_dir, exist_ok=True)
    cmd = [binary, gt_dir, det_dir, out_dir] + (["low_iou"] if low_iou else [])
    result = subprocess.run(cmd, check=True, capture_output=True, text=True)
    aps = {}
    for line in result.stdout.splitlines():
        m = re.match(r"(\w+) (?:AP|AHS): ([\d.]+) ([\d.]+) ([\d.]+)", line)
        if m:
            aps[m.group(1)] = tuple(float(m.group(i)) for i in (2, 3, 4))
    return aps


def run_kitti_native_eval_async(gt_dir: str, det_dir: str,
                                out_dir: Optional[str] = None) -> multiprocessing.Process:
    """`run_kitti_native_eval` in a started child process (spawned), which
    writes the evaluator's files; returns the process to join. The binary
    is built here first, so that children never compile it at once."""
    ensure_built()
    proc = multiprocessing.get_context("spawn").Process(
        target=run_kitti_native_eval, args=(gt_dir, det_dir, out_dir))
    proc.start()
    return proc
