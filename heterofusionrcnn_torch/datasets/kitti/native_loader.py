"""ctypes binding of the native point-cloud loader (parity with
heterofusionrcnn_tpu/datasets/kitti/native_loader.py).

`native/dataloader/dataloader.cpp`, shared with the JAX package, fuses the
velodyne decode, the rect transform and the image-frustum filter into one
C++ pass (`hfr_load_and_filter`). It is compiled here with `g++ -O3
-std=c++17 -fPIC -shared` at first use into `runtime/_build/` (listed in
`.gitignore`), under a name that hashes the source and the flags, so an
edited source rebuilds; the library committed beside the source is not
used. A failed build or load raises with the compiler's message: there is
no quiet fallback, and `pointcloud.get_lidar_point_cloud_numpy` stays the
plain version the tests hold this one against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[3] / "native" / "dataloader" / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "runtime" / "_build"
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
_POINT_BYTES = 16  # x, y, z, intensity as float32

_lib = None


def ensure_built(source: Path = SOURCE) -> str:
    """Path of the loader library, compiled if missing."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libhfr_dataloader-{digest}.so"
    if not lib.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        try:
            done = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(source)],
                                  capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(f"native loader: cannot run the compiler {cxx!r}: {exc}") from exc
        if done.returncode != 0:
            raise RuntimeError(f"native loader: {cxx} failed on {source}:\n{done.stderr}")
        os.replace(tmp, lib)
    return str(lib)


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        dp = ctypes.POINTER(ctypes.c_double)
        lib.hfr_load_and_filter.restype = ctypes.c_int
        lib.hfr_load_and_filter.argtypes = [ctypes.c_char_p, dp, dp, dp, ctypes.c_float,
                                            ctypes.c_float, ctypes.POINTER(ctypes.c_float),
                                            ctypes.c_int]
        _lib = lib
    return _lib


def load_and_filter_native(velo_path: str, calib, im_size) -> np.ndarray:
    """The velodyne file's points in the rect camera frame, in front of the
    camera and inside the (w, h) image `im_size`: (N, 4) float32
    [x, y, z, intensity]. The output buffer holds every point of the file
    (its bytes / 16), so a scan of any size loads. Raises OSError when the
    file cannot be read."""
    lib = _get_lib()
    capacity = os.path.getsize(velo_path) // _POINT_BYTES
    tr = np.ascontiguousarray(calib.tr_velodyne_to_cam, np.float64)
    r0 = np.ascontiguousarray(calib.r0_rect, np.float64)
    p2 = np.ascontiguousarray(calib.p2, np.float64)
    out = np.empty((max(capacity, 1), 4), np.float32)
    dp = ctypes.POINTER(ctypes.c_double)
    n = lib.hfr_load_and_filter(
        os.fsencode(velo_path), tr.ctypes.data_as(dp), r0.ctypes.data_as(dp),
        p2.ctypes.data_as(dp), float(im_size[0]), float(im_size[1]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), capacity,
    )
    if n == -1:
        raise OSError(f"native loader: cannot read {velo_path}")
    if n < 0:
        raise RuntimeError(f"native loader: {velo_path} returned {n} with room for "
                           f"{capacity} points")
    return out[:n].copy()
