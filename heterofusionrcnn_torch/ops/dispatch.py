"""Device dispatch and the build of the hand-written CUDA kernels.

Every kernel is reached through a PyTorch custom op of the namespace
`hfr` (`torch.ops.hfr.*`, registered by the op modules beside their
wrappers; importing `heterofusionrcnn_torch.ops.library` registers them
all). Each op has two implementations, chosen by the dispatcher's device
key: on CUDA tensors the kernel's launch, on CPU tensors the plain PyTorch
version that sits beside it; and a fake (shape) function, through which
`torch.export` traces it. There is no switch that forces the plain version
onto the card and no `try` that falls back to it: a kernel that does not
build or launch raises, and so do inputs on two devices (`one_device`).

Each `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface, loaded with `ctypes`, at first use
(`build_all` compiles every missing library at once, one `nvcc` process per
source). Libraries land in `ops/_build/` (listed in `.gitignore`) under a
name that hashes the source, the `csrc/*.cuh` headers it includes and the
flags, so an edited source or header rebuilds.
Each library exports `int <fn>(..., void* stream)` returning the
`cudaError_t` of its launch, and `const char* hfr_error_string(int)`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
_BASE_FLAGS = [
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Index-exact kernels (KNN, FPS, NMS) must round every product and sum the
# way the plain PyTorch version does: no fused multiply-add contraction.
_EXACT_FLAGS = ["--fmad=false"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def one_device(*tensors: Optional[torch.Tensor]) -> torch.device:
    """The one device of the given tensors (None entries aside); raises
    for inputs on two devices. The ops' implementations call it: the
    dispatcher picks the CUDA implementation when any input is on the
    card, and a kernel must not be handed a host pointer."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs on {sorted(map(str, devs))}")
    return devs.pop()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


class CudaKernel:
    """C functions of one `csrc/<name>.cu` source: its build and their count
    of launches (`launches`, raised by one in `launch` and nowhere else).
    Two objects may share a source (and its library) to count two of its
    kernels apart; `name` then tells them apart."""

    def __init__(self, source: str, functions: Dict[str, Sequence], exact: bool,
                 name: Optional[str] = None):
        self.source = CSRC_DIR / source
        self._name = name
        self.functions = dict(functions)
        self.flags = _ARCH_FLAGS + _BASE_FLAGS + (_EXACT_FLAGS if exact else [])
        self.launches = 0
        self.build_log = ""
        self._lib = None

    @property
    def name(self) -> str:
        return self._name or self.source.stem

    def headers(self) -> List[Path]:
        """The headers the source includes with quotes, directly or through
        another header, resolved beside the including file."""
        found, todo = [], [self.source]
        while todo:
            src = todo.pop()
            for name in _INCLUDE.findall(src.read_text()):
                path = (src.parent / name).resolve()
                if path not in found:
                    found.append(path)
                    todo.append(path)
        return sorted(found)

    @property
    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in self.headers():
            h.update(header.name.encode())
            h.update(header.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{h.hexdigest()[:16]}.so"

    def command(self, out: Path) -> List[str]:
        return [_nvcc(), *self.flags, "-o", str(out), str(self.source)]

    def load(self):
        if self._lib is None:
            if not self.lib_path.exists():
                build_all([self])
            lib = ctypes.CDLL(str(self.lib_path))
            for fn, argtypes in self.functions.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = I
            lib.hfr_error_string.argtypes = [I]
            lib.hfr_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, fn: str, *args) -> None:
        """Call `fn` on the current stream; raise on a refused launch."""
        lib = self.load()
        err = getattr(lib, fn)(*args, P(torch.cuda.current_stream().cuda_stream))
        if err:
            msg = lib.hfr_error_string(err).decode()
            raise RuntimeError(f"{self.name}: {fn} failed: {msg} ({err})")
        self.launches += 1


def build_all(kernels: Iterable[CudaKernel]) -> None:
    """Compile every kernel whose library is missing, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seen = [], set()
    for k in kernels:
        if k.lib_path.exists() or k.lib_path in seen:
            continue
        seen.add(k.lib_path)
        tmp = k.lib_path.with_suffix(f".{os.getpid()}.tmp")
        procs.append(
            (k, tmp, subprocess.Popen(
                k.command(tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ))
        )
    failed = []
    for k, tmp, proc in procs:
        out, _ = proc.communicate()
        k.build_log = out
        if proc.returncode != 0:
            failed.append(f"{k.source.name}:\n{out}")
            continue
        os.replace(tmp, k.lib_path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def pointers(*tensors: torch.Tensor) -> List[P]:
    """Device pointers of contiguous tensors (None -> NULL)."""
    out = []
    for t in tensors:
        if t is None:
            out.append(P(None))
            continue
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        out.append(P(t.data_ptr()))
    return out


# Thread-block clusters (fps.cu, nms.cu): a set of items runs on a cluster
# of 1, 2, 4, 8 or 16 CTAs on neighbouring SMs (16 is Hopper's largest,
# non-portable, size).
MAX_CLUSTER = 16


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (torch keeps the
    properties it has read)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def cluster_threads(n: int, cluster: int, per_thread: int = 1) -> int:
    """Threads of each CTA when n items are shared over `cluster` CTAs,
    `per_thread` items a thread: whole warps, at most 1024."""
    share = -(-n // cluster)
    return min(1024, 32 * -(-share // (32 * per_thread)))


def cluster_plan(b: int, n: int, sms: int, per_cta: int, per_thread: int,
                 fits: Callable[[int, int], bool], least: int = 1) -> Tuple[int, int]:
    """(cluster size C, threads a CTA) for b sets of n items.

    C starts at `least` and doubles while a CTA's share of a set holds more
    than `per_cta` items and the b * 2C CTAs still fit on the `sms` SMs,
    up to MAX_CLUSTER; it then halves (not below `least`) while
    `fits(C, threads)` says that not one such cluster fits on the card (the
    kernel's occupancy query). Each CTA has `per_thread` items a thread
    (`cluster_threads`). Raises when no cluster fits.
    """
    c = least
    while c < MAX_CLUSTER and -(-n // c) > per_cta and b * 2 * c <= sms:
        c *= 2
    while c > least and not fits(c, cluster_threads(n, c, per_thread)):
        c //= 2
    threads = cluster_threads(n, c, per_thread)
    if not fits(c, threads):
        raise RuntimeError(f"no cluster of {c} CTAs fits for sets of {n} items")
    return c, threads
