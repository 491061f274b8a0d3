"""The port's KITTI data layer, writer, evaluator driver and checkpoints
against the JAX package on the fixture frames (tests/fixtures/kitti).

- `KittiDataset`: the same batches as the JAX loader (which takes its
  native C++ point-cloud path here): points, P2, labels and clusters byte
  for byte; images within 1 grey level (OpenCV's resize against the port's
  integer copy of it).
- PNG decoding equal to `cv2.imread`, for the fixtures and for every PNG
  filter type; resizing within 1 grey level of `cv2.resize`.
- KITTI rows byte-identical to the JAX writer's; the same AP table from
  the shared native evaluator.
- A checkpoint round trip.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from heterofusionrcnn_tpu.configs import presets as jax_presets
from heterofusionrcnn_tpu.datasets.kitti.dataset import KittiDataset as JaxKittiDataset
from heterofusionrcnn_tpu.runtime.kitti_writer import (
    save_predictions_in_kitti_format as jax_save_predictions,
)
from heterofusionrcnn_tpu.runtime.native_eval import run_kitti_native_eval as jax_native_eval

from heterofusionrcnn_torch.configs import presets
from heterofusionrcnn_torch.datasets.kitti import image
from heterofusionrcnn_torch.datasets.kitti.dataset import KittiDataset
from heterofusionrcnn_torch.models.extractors.layers import DenseBN, init_weights
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
from heterofusionrcnn_torch.runtime.kitti_writer import save_predictions_in_kitti_format
from heterofusionrcnn_torch.runtime.native_eval import run_kitti_native_eval

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "kitti"
PNGS = sorted((FIXTURE / "training" / "image_2").glob("*.png"))


def _datasets(split, mode, aug):
    out = []
    for preset in (jax_presets.rpn_multiclass, presets.rpn_multiclass):
        cfg = preset(str(FIXTURE))
        cfg.dataset_config.data_split = split
        cfg.dataset_config.aug_list = ["flipping", "pca_jitter"] if aug else []
        out.append(cfg.dataset_config)
    return JaxKittiDataset(out[0], mode), KittiDataset(out[1], mode)


@pytest.mark.parametrize("split,mode,shuffle,size", [
    ("val", "test", False, (16384, 1200, 360)),
    ("train", "train", True, (2048, 384, 120)),
])
def test_dataset_batches_match_jax(split, mode, shuffle, size):
    """Every batch of one epoch (val, in order, full width), or three
    shuffled, augmented training batches of two frames."""
    ds_jax, ds = _datasets(split, mode, aug=mode == "train")
    for a, b in zip(ds_jax.clusters + ds_jax.std_devs, ds.clusters + ds.std_devs):
        np.testing.assert_array_equal(a, b)
    pts, w, h = size
    kw = dict(shuffle=shuffle, model="rpn", pc_sample_pts=pts, img_w=w, img_h=h)
    bs, steps = (1, ds.num_samples) if mode == "test" else (2, 3)
    for _ in range(steps):
        want, want_names = ds_jax.next_batch(bs, **kw)
        got, got_names = ds.next_batch(bs, **kw)
        assert got_names == want_names
        assert sorted(got) == sorted(want)
        for key, val in want.items():
            if key == "image_input":
                assert got[key].shape == val.shape
                assert np.abs(got[key] - val).max() <= 1.0
            else:
                assert got[key].dtype == val.dtype, key
                np.testing.assert_array_equal(got[key], val, err_msg=key)
    assert ds.epochs_completed == ds_jax.epochs_completed


@pytest.mark.parametrize("path", PNGS, ids=lambda p: p.name)
def test_png_decode_and_resize_match_opencv(path):
    rgb = image.read_png(str(path))
    bgr = cv2.imread(str(path))
    np.testing.assert_array_equal(rgb, bgr[..., ::-1])
    assert image.png_size(str(path)) == (bgr.shape[1], bgr.shape[0])
    for w, h in ((1200, 360), (384, 120)):
        got = image.resize_bilinear(rgb, w, h).astype(np.int16)
        want = cv2.resize(np.ascontiguousarray(bgr[..., ::-1]), (w, h)).astype(np.int16)
        assert np.abs(got - want).max() <= 1


def _encode_png(img: np.ndarray, filters) -> bytes:
    """A PNG with the given filter type per row (for the decoder's test)."""
    h, w, c = img.shape
    prev = np.zeros(w * c, np.int32)
    raw = bytearray()
    for y in range(h):
        line = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        kind = filters[y % len(filters)]
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw.append(kind)
        raw += ((line - pred) % 256).astype(np.uint8).tobytes()
        prev = line

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("seed", [30, 31])
def test_png_decoder_every_filter_type(tmp_path, seed):
    img = np.random.default_rng(seed).integers(0, 256, (11, 9, 3)).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_encode_png(img, filters=[0, 1, 2, 3, 4, 4, 3, 2, 1, 0, 3]))
    np.testing.assert_array_equal(image.decode_png(path.read_bytes()), img)
    want = cv2.imread(str(path))[..., ::-1]
    np.testing.assert_array_equal(image.read_png(str(path)), want)


def test_kitti_writer_and_eval_match_jax(tmp_path):
    """The same prediction files through both writers give byte-identical
    KITTI rows, and both evaluator drivers the same AP table."""
    ds_jax, ds = _datasets("val", "test", aug=False)
    rng = np.random.default_rng(31)
    final = tmp_path / "pred" / "final_predictions_and_scores" / "val" / "5"
    final.mkdir(parents=True)
    for k, name in enumerate(sorted({s.name for s in ds.sample_list})):
        if k == 1:
            continue  # a frame without predictions
        n = 12
        rows = np.zeros((n, 9))
        rows[:, 0] = rng.uniform(-15, 15, n)
        rows[:, 1] = rng.uniform(0.5, 2.0, n)
        rows[:, 2] = rng.uniform(5, 45, n)
        rows[:, 3:6] = rng.uniform([3.2, 1.4, 1.3], [4.5, 1.9, 1.8], (n, 3))
        rows[:, 6] = rng.uniform(-np.pi, np.pi, n)
        rows[:, 7] = rng.uniform(0, 1, n)
        rows[:, 8] = rng.integers(0, 3, n)
        np.savetxt(final / f"{name}.txt", rows, fmt="%.5f")
    want_dir = jax_save_predictions(ds_jax, str(tmp_path / "pred"), 0.1, 5,
                                    out_dir=str(tmp_path / "jax"))
    got_dir = save_predictions_in_kitti_format(ds, str(tmp_path / "pred"), 0.1, 5,
                                               out_dir=str(tmp_path / "port"))
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir)) and len(names) == ds.num_samples
    assert sum(os.path.getsize(os.path.join(got_dir, f)) for f in names) > 0
    for f in names:
        assert Path(got_dir, f).read_bytes() == Path(want_dir, f).read_bytes(), f
    want = jax_native_eval(ds_jax.label_dir, want_dir, str(tmp_path / "eval_jax"))
    got = run_kitti_native_eval(ds.label_dir, got_dir, str(tmp_path / "eval_port"))
    assert got == want and len(got) == 12


def test_checkpoint_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None
    mods = [init_weights(DenseBN(4, 3), s) for s in range(3)]
    for step, m in zip((5, 10, 20), mods):
        m.BatchNorm_0.running_mean.fill_(0.1 * step)
        mgr.save(step, m)
    mgr.close()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.all_steps() == [10, 20] and mgr.latest_step() == 20
    raw = mgr.restore_raw()
    assert raw["step"] == 20
    back = DenseBN(4, 3)
    back.load_state_dict(raw["state_dict"])
    for k, v in mods[2].state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    assert torch.equal(mgr.restore_raw(10)["state_dict"]["BatchNorm_0.running_mean"],
                       torch.full((3,), 1.0))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_raw()
