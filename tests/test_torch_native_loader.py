"""The port's native point-cloud loader (`heterofusionrcnn_torch/datasets/
kitti/native_loader.py`, `native/dataloader/dataloader.cpp` compiled at
first use) against the JAX package's native loader and the port's numpy
path: the same points, byte for byte, on every fixture frame; a scan
larger than the JAX binding's fixed 200,000-point buffer; and the errors
(a missing file, a failed build)."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest

from heterofusionrcnn_tpu.datasets.kitti.native_loader import (
    load_and_filter_native as jax_load_and_filter_native,
)

from heterofusionrcnn_torch.datasets.kitti import calib as calib_io
from heterofusionrcnn_torch.datasets.kitti import image as image_io
from heterofusionrcnn_torch.datasets.kitti import native_loader, pointcloud

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "kitti" / "training"
FRAMES = sorted(int(p.stem) for p in (FIXTURE / "velodyne").glob("*.bin"))


def _im_size(idx):
    h, w = image_io.read_png(str(FIXTURE / "image_2" / ("%06d.png" % idx))).shape[:2]
    return [w, h]


@pytest.mark.parametrize("idx", FRAMES)
def test_fixture_frames_byte_equal(idx):
    im_size = _im_size(idx)
    calib_dir, velo_dir = str(FIXTURE / "calib"), str(FIXTURE / "velodyne")
    got = pointcloud.get_lidar_point_cloud(idx, calib_dir, velo_dir, im_size)
    numpy_path = pointcloud.get_lidar_point_cloud_numpy(idx, calib_dir, velo_dir, im_size)
    jax_native = jax_load_and_filter_native(
        os.path.join(velo_dir, "%06d.bin" % idx), calib_io.read_calibration(calib_dir, idx),
        im_size)
    assert jax_native is not None  # the JAX binding loaded its library
    assert got.dtype == np.float32 and got.shape[1] == 4 and len(got) > 1000
    assert got.tobytes() == numpy_path.tobytes()
    assert got.tobytes() == jax_native.tobytes()
    # Without im_size: the unfiltered cloud, as the numpy path has it.
    full = pointcloud.get_lidar_point_cloud(idx, calib_dir, velo_dir)
    assert len(full) == os.path.getsize(os.path.join(velo_dir, "%06d.bin" % idx)) // 16


def test_scan_larger_than_the_fixed_buffer(tmp_path):
    """250,000 points in front of the camera: the JAX binding's 200,000-point
    buffer is too small (its C call returns -2 and it gives None); the
    port sizes its buffer from the file and returns every point, as the
    numpy path does."""
    idx = FRAMES[0]
    rng = np.random.default_rng(0)
    calib = calib_io.read_calibration(str(FIXTURE / "calib"), idx)
    # Points ahead of the car (velodyne x forward), within the image.
    n = 250_000
    xyzi = np.stack([rng.uniform(5, 60, n), rng.uniform(-3, 3, n), rng.uniform(-1.5, 1, n),
                     rng.uniform(0, 1, n)], axis=1).astype(np.float32)
    velo_dir = tmp_path / "velodyne"
    velo_dir.mkdir()
    xyzi.tofile(velo_dir / ("%06d.bin" % idx))
    im_size = _im_size(idx)
    got = pointcloud.get_lidar_point_cloud(idx, str(FIXTURE / "calib"), str(velo_dir), im_size)
    want = pointcloud.get_lidar_point_cloud_numpy(idx, str(FIXTURE / "calib"), str(velo_dir),
                                                  im_size)
    assert len(got) > 200_000
    assert got.tobytes() == want.tobytes()
    assert jax_load_and_filter_native(str(velo_dir / ("%06d.bin" % idx)), calib, im_size) is None


def test_missing_file_raises(tmp_path):
    calib = calib_io.read_calibration(str(FIXTURE / "calib"), FRAMES[0])
    with pytest.raises(OSError):
        native_loader.load_and_filter_native(str(tmp_path / "missing.bin"), calib, [1242, 375])


def test_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    bad = tmp_path / "dataloader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed on"):
        native_loader.ensure_built(bad)
    assert not list((tmp_path / "build").glob("*.so"))
