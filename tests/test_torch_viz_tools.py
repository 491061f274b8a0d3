"""The port's dataset-statistics and prediction-viewing tools
(`tools/torch_dataset_stats.py`, `tools/torch_show_predictions{,_2d,_3d}.py`)
against the JAX package's tools on tests/fixtures/kitti, and the two
package-free plotting tools on files the port writes.

- `histograms`: the same stats.json and hist_<class>.png names; `mean`: the
  same printed lines (the port reads PNGs with `image.read_png`, RGB, where
  the JAX tool flips `cv2.imread`'s BGR).
- The 3D viewer's HTML, its `DATA` JSON included, byte for byte, with GT,
  proposals and predictions.
- `show_predictions` and `show_predictions_2d`: every drawing call (the
  image shown, the projected box corners, the BEV footprints, the 2D boxes
  and their text) recorded on stand-in axes and equal call for call; a real
  run of each writes the same PNG names (their bytes are not compared).
- Without matplotlib (the card's machine) the PNG modes raise ImportError
  naming it; `mean` and the HTML export run.
- `tools/plot_generalization.py` reads the curve CSVs that
  `tools/torch_run_generalization.py`'s writer makes.
"""

from __future__ import annotations

import json
import os
import re
import sys
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest

from tools import dataset_stats as j_stats
from tools import plot_generalization
from tools import show_predictions as j_show
from tools import show_predictions_2d as j_show2d
from tools import show_predictions_3d as j_show3d
from tools import torch_dataset_stats as t_stats
from tools import torch_run_generalization
from tools import torch_show_predictions as t_show
from tools import torch_show_predictions_2d as t_show2d
from tools import torch_show_predictions_3d as t_show3d

FIXTURE = str(Path(__file__).resolve().parent / "fixtures" / "kitti")
STEP, SPLIT = "7", "val"


@pytest.fixture(scope="module")
def predictions(tmp_path_factory):
    """A predictions tree over the fixture's train and val frames:
    proposals (rows box + score) and final predictions (box + score +
    class) where the evaluators write them, the final rows also where the
    JAX 3D viewer reads them (final_predictions_and_scores/<step>); one box
    behind the camera and one below the score threshold a frame."""
    root = tmp_path_factory.mktemp("preds")
    rng = np.random.default_rng(5)
    for split in ("train", "val"):
        dirs = [root / "proposals_and_scores" / split / STEP,
                root / "final_predictions_and_scores" / split / STEP,
                root / "final_predictions_and_scores" / STEP]
        for d in dirs:
            d.mkdir(parents=True, exist_ok=True)
        for name in (Path(FIXTURE) / f"{split}.txt").read_text().split():
            _write_frame(dirs, name, rng)
    return root


def _write_frame(dirs, name, rng):
    n = 4
    boxes = np.column_stack([rng.uniform(-8, 8, n), rng.uniform(1.4, 1.8, n),
                             rng.uniform(8, 40, n), rng.uniform(3.5, 4.2, n),
                             rng.uniform(1.5, 1.8, n), rng.uniform(1.4, 1.6, n),
                             rng.uniform(-np.pi, np.pi, n)])
    boxes[0, 2] = -5.0  # behind the camera: dropped by the 2D views
    scores = np.array([0.95, 0.8, 0.5, 0.05])  # the last below 0.1
    np.savetxt(dirs[0] / f"{name}.txt", np.column_stack([boxes, scores]), fmt="%.5f")
    final = np.column_stack([boxes, scores, rng.integers(0, 3, n)])
    for d in dirs[1:]:
        np.savetxt(d / f"{name}.txt", final, fmt="%.5f")


def _plain(x):
    """A recorded argument as plain data: arrays as lists, patches as their
    kind and geometry."""
    from matplotlib.patches import Polygon, Rectangle

    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, Polygon):
        return ("Polygon", x.get_xy().tolist(), x.get_edgecolor(), x.get_linewidth())
    if isinstance(x, Rectangle):
        return ("Rectangle", x.get_xy(), x.get_width(), x.get_height(), x.get_edgecolor(),
                x.get_linestyle())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


class _Recorder:
    """Stands in for a matplotlib figure or axes: records every call."""

    def __init__(self, log, name):
        self._log, self._name = log, name

    def __getattr__(self, attr):
        def call(*args, **kwargs):
            self._log.append((self._name, attr, _plain(list(args)),
                              {k: _plain(v) for k, v in sorted(kwargs.items())}))
        return call


class _FakePyplot:
    """Stands in for matplotlib.pyplot: figures and axes that record."""

    def __init__(self):
        self.log = []

    def subplots(self, nrows=1, ncols=1, **kwargs):
        n = len([e for e in self.log if e[1] == "figure"])
        self.log.append(("plt", "figure", [nrows, ncols], {}))
        axes = [_Recorder(self.log, f"fig{n}.ax{i}") for i in range(nrows * ncols)]
        return _Recorder(self.log, f"fig{n}"), axes[0] if len(axes) == 1 else tuple(axes)

    def close(self, fig):
        pass


def _run_jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["tool"] + argv)
    module.main()


# --------------------------------------------------------------- statistics


def test_histograms_write_the_same_stats(tmp_path, capsys):
    args = dict(dataset_dir=FIXTURE, data_split="trainval", classes=None)
    for tool, out in ((j_stats, "jax"), (t_stats, "port")):
        tool.cmd_histograms(Namespace(out_dir=str(tmp_path / out), **args))
    printed = capsys.readouterr().out
    got, want = (json.loads((tmp_path / k / "stats.json").read_text()) for k in ("port", "jax"))
    assert got == want and want["Car"]["count"] > 0
    assert (sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
            == ["hist_car.png", "hist_cyclist.png", "hist_pedestrian.png", "stats.json"])
    assert printed.count(json.dumps(want, indent=2)) == 2


@pytest.mark.parametrize("split", ["train", "val"])
def test_mean_prints_the_same_lines(split, capsys):
    lines = []
    for tool in (j_stats, t_stats):
        tool.cmd_mean(Namespace(dataset_dir=FIXTURE, data_split=split))
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1]
    assert re.match(r"RGB means: \[\d+\.\d{4}, \d+\.\d{4}, \d+\.\d{4}\]\n", lines[1])


# ---------------------------------------------------------------- 3D viewer


def test_scene_html_equals_the_jax_tool(tmp_path, predictions, monkeypatch):
    """On the train split, which JAX's tool shows whatever --data_split
    says (the port's shows the split named)."""
    flags = ["--dataset_dir", FIXTURE, "--data_split", "train", "--predictions_dir",
             str(predictions), "--step", STEP, "--show_proposals", "--max_samples", "3"]
    _run_jax_main(j_show3d, flags + ["--out_dir", str(tmp_path / "jax")], monkeypatch)
    t_show3d.main(flags + ["--out_dir", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 3 and sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        got, want = ((tmp_path / k / name).read_text() for k in ("port", "jax"))
        data = json.loads(re.search(r"const DATA = (\{.*?\});\n", got, re.S).group(1))
        # GT, 4 proposals and the 3 predictions at or above 0.1
        assert len(data["boxes"]) >= 7 and len(data["points"]) > 1000
        assert got == want, name


# ------------------------------------------------------------ 2D and BEV views


def test_show_predictions_draws_the_same_geometry(tmp_path, predictions, monkeypatch):
    flags = ["--dataset_dir", FIXTURE, "--data_split", SPLIT, "--predictions_dir",
             str(predictions), "--step", STEP, "--max_samples", "3"]
    logs = []
    for tool in (j_show, t_show):  # the same --out_dir: nothing is written
        fake = _FakePyplot()
        if tool is j_show:
            monkeypatch.setattr(j_show, "plt", fake)
            _run_jax_main(j_show, flags + ["--out_dir", str(tmp_path)], monkeypatch)
        else:
            monkeypatch.setattr(t_show, "_pyplot", lambda: fake)
            t_show.main(flags + ["--out_dir", str(tmp_path)])
        logs.append(fake.log)
    kinds = [e[1] for e in logs[1]]
    assert kinds.count("figure") == 3 and kinds.count("imshow") == 3
    assert kinds.count("add_patch") > 3 and kinds.count("plot") > 12 * 3
    assert logs[1] == logs[0]


def test_show_predictions_2d_draws_the_same_geometry(tmp_path, predictions, monkeypatch):
    flags = ["--dataset_dir", FIXTURE, "--data_split", SPLIT, "--predictions_dir",
             str(predictions), "--views", "proposals,predictions,overlaid", "--max_samples", "3"]
    logs = []
    for tool in (j_show2d, t_show2d):
        fake = _FakePyplot()
        if tool is j_show2d:
            monkeypatch.setattr(j_show2d, "plt", fake)
            _run_jax_main(j_show2d, flags + ["--out_dir", str(tmp_path)], monkeypatch)
        else:
            monkeypatch.setattr(t_show2d, "_pyplot", lambda: fake)
            t_show2d.main(flags + ["--out_dir", str(tmp_path)])
        logs.append(fake.log)
    kinds = [e[1] for e in logs[1]]
    assert kinds.count("figure") == 9 and kinds.count("imshow") == 9
    assert kinds.count("add_patch") > 0 and kinds.count("text") > 0
    assert logs[1] == logs[0]


def test_viewers_write_the_same_pngs(tmp_path, predictions, monkeypatch):
    """One frame through each real matplotlib view; the same file names."""
    common = ["--dataset_dir", FIXTURE, "--predictions_dir", str(predictions),
              "--max_samples", "1"]
    runs = [(j_show, t_show, common + ["--data_split", SPLIT, "--step", STEP]),
            (j_show2d, t_show2d, common + ["--data_split", SPLIT, "--views",
                                           "proposals,predictions,overlaid"]),
            (j_show3d, t_show3d, common + ["--data_split", "train", "--step", STEP, "--png"])]
    for j_tool, t_tool, flags in runs:
        jax_dir, port_dir = tmp_path / j_tool.__name__ / "jax", tmp_path / j_tool.__name__ / "port"
        _run_jax_main(j_tool, flags + ["--out_dir", str(jax_dir)], monkeypatch)
        t_tool.main(flags + ["--out_dir", str(port_dir)])
        want = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*.png"))
        got = sorted(p.relative_to(port_dir) for p in port_dir.rglob("*.png"))
        assert got == want and want, j_tool.__name__
        assert all((port_dir / p).stat().st_size > 10000 for p in got)


# ------------------------------------------------------------ no matplotlib


def test_host_tools_without_matplotlib(tmp_path, predictions, monkeypatch, capsys):
    """The card's machine has no matplotlib: the PNG modes raise ImportError
    naming it, no fallback; `mean` and the HTML export run."""
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        t_stats.cmd_histograms(Namespace(dataset_dir=FIXTURE, data_split="val", classes=None,
                                         out_dir=str(tmp_path / "h")))
    flags = ["--dataset_dir", FIXTURE, "--data_split", SPLIT, "--predictions_dir",
             str(predictions), "--max_samples", "1"]
    for tool, extra in ((t_show, ["--step", STEP]), (t_show2d, []),
                        (t_show3d, ["--step", STEP, "--png"])):
        with pytest.raises(ImportError, match="matplotlib"):
            tool.main(flags + extra + ["--out_dir", str(tmp_path / tool.__name__)])
    t_stats.main(["mean", "--dataset_dir", FIXTURE])
    assert capsys.readouterr().out.startswith("RGB means: [")
    t_show3d.main(flags + ["--step", STEP, "--out_dir", str(tmp_path / "html")])
    assert len(list((tmp_path / "html").glob("*.html"))) == 1


# ----------------------------------------------------------- plotting tools


def test_plot_generalization_reads_the_port_curves(tmp_path, monkeypatch):
    gen = tmp_path / "generalization"
    recall = [[1, 0.25, 0.125, 0.5], [2, 0.5, 0.25, 0.75]]
    ap = [[1, 10.5, 0.0, 2.25], [2, 12.75, 1.5, 3.0]]
    torch_run_generalization._write_csv(str(gen / "rpn_recall_curve.csv"),
                                        torch_run_generalization.RPN_CURVE_HEADER, recall)
    torch_run_generalization._write_csv(str(gen / "rcnn_ap_curve.csv"),
                                        torch_run_generalization.RCNN_CURVE_HEADER, ap)
    assert plot_generalization._rows(str(gen / "rpn_recall_curve.csv")) == recall
    assert plot_generalization._rows(str(gen / "rcnn_ap_curve.csv")) == ap
    monkeypatch.setattr(sys, "argv", ["plot_generalization", "--gen_dir", str(gen)])
    plot_generalization.main()
    assert (gen / "curves.png").stat().st_size > 10000
