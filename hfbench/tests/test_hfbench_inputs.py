"""The benchmark's inputs: the frozen loader reads the fixture frames as
the port's data layer does, refuses a fixture whose bytes differ from the
recorded sha256, and gives every seed the same frames the same number of
times."""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

import hfbench_cells  # noqa: F401
from hfbench.inputs import kitti, traffic


def test_frames_match_the_ports_loader():
    from heterofusionrcnn_torch.datasets.kitti import image, pointcloud

    frames = kitti.load_frames(["000008", "000142"])
    for name, f in frames.items():
        d = kitti.FIXTURE_DIR
        idx = int(name)
        im = image.read_png(os.path.join(d, "image_2", name + ".png"))
        assert np.array_equal(im, f["image"])
        pts = pointcloud.get_lidar_point_cloud_numpy(
            idx, os.path.join(d, "calib"), os.path.join(d, "velodyne"),
            im_size=[im.shape[1], im.shape[0]])
        assert np.array_equal(pts, f["points"])
        assert np.array_equal(image.resize_bilinear(im, 1200, 360),
                              kitti.resize_bilinear(f["image"], 1200, 360))


def test_labels_match_the_ports():
    from heterofusionrcnn_torch.configs.presets import rpn_multiclass
    from heterofusionrcnn_torch.datasets.kitti.dataset import KittiDataset

    cfg = rpn_multiclass(os.path.dirname(kitti.FIXTURE_DIR)).dataset_config
    ds = KittiDataset(cfg, "val")
    f = kitti.load_frames(["000007"])["000007"]
    pts = f["points"][:4096, :3]
    seg, reg = kitti.rpn_labels(pts, f["boxes"], f["classes"])
    want_seg, want_reg = ds.generate_rpn_training_labels(pts, f["boxes"], f["classes"])
    assert np.array_equal(seg, want_seg) and np.array_equal(reg, want_reg)
    assert (seg > 0).any()


def test_changed_fixture_is_refused(tmp_path, monkeypatch):
    dst = tmp_path / "tests" / "fixtures" / "kitti"
    shutil.copytree(os.path.dirname(kitti.FIXTURE_DIR), dst)
    path = dst / "training" / "calib" / "000003.txt"
    path.write_text(path.read_text().replace("7.", "8.", 1))
    monkeypatch.setattr(kitti, "REPO", str(tmp_path))
    monkeypatch.setattr(kitti, "FIXTURE_DIR", str(dst / "training"))
    kitti.load_frames(["000002"])
    with pytest.raises(kitti.FixtureMismatch, match="000003.txt"):
        kitti.load_frames(["000002", "000003"])


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**40 + 7])
def test_every_seed_stages_the_same_frames(seed):
    t = {"batch": 4, "repeats": 4, "flipped_share": 0.5}
    names = kitti.frame_names()
    plan = traffic.schedule(t, names, seed)
    slots = sorted(s for batch in plan for s in batch)
    assert slots == sorted((n, i, i < 2) for n in names for i in range(4))
    assert all(len(b) == 4 for b in plan)
