"""The port's RCNN evaluator and the evaluation CLI's RCNN branch on the CPU.

- `RcnnEvaluator` at `rcnn_unittest` (val mode, 16 RoIs a frame) on a
  synthetic handoff over the fixture val frames (tests/rcnn_fixtures.py
  `write_handoff`), against the JAX package's `RcnnEvaluator` from the same
  weights (`heterofusionrcnn_torch.convert`): the final prediction files
  (rows of %.5f) within 2e-5, compared as sets of rows (the rows of equal
  scores may come in either order), the KITTI files within 1e-2 (their
  numbers are rounded to 3 decimals, as tests/test_evaluator_batched.py
  holds them), the ledgers rcnn_avg_losses.csv and rcnn_avg_cls_acc.csv
  row for row within 1e-4 and the summary's avg_cls_acc. The port runs
  batches of 1 and of 2 (the last one padded), the JAX evaluator batches
  of 1; the port's batch 2 against its batch 1 at the same tolerances.
- tools/plot_ap.py reads the AP summary the port's evaluator writes.
- `repeated_checkpoint_run` with `num_rois=16` writes what the one-shot
  path writes at 16 RoIs (the JAX watcher drops `num_rois`), and skips the
  steps it evaluated.
- The four port CLIs in sequence on the CPU: RPN training, its evaluation
  over the val split (watcher) and the train split (the handoff), RCNN
  training, the RCNN's evaluation over the val handoff (one-shot, then the
  watcher).

The weights are flax variables drawn from a seed (tests/test_torch_layers.py)
with every BatchNorm holding the first eval batch's own statistics, as a
trained network's would be close to them: random running statistics let
the activations grow layer by layer to logits of ~50, where float32
rounding alone moves them by ~1e-3 (`PERF.md`). The refinement head's
kernel and bias are scaled by 0.1, as tests/test_torch_evaluator.py scales
the RPN's proposal head: at random weights its size residuals reach the
box through an exponential, and the decoded sizes of two float32 runs
then differ beyond the fifth decimal the files print. The
JAX PointCNN takes the direct-distance KNN (tests/test_torch_layers.py).
"""

from __future__ import annotations

import csv
import glob
import json
import os

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax

from heterofusionrcnn_tpu.configs import presets as jax_presets
from heterofusionrcnn_tpu.datasets.kitti.dataset import KittiDataset as JaxKittiDataset
from heterofusionrcnn_tpu.experiments import common as jax_common
from heterofusionrcnn_tpu.models.extractors import pointcnn as j_pointcnn
from heterofusionrcnn_tpu.ops.pallas_knn import _knn_reference_jnp
from heterofusionrcnn_tpu.runtime import evaluator as j_evaluator

from heterofusionrcnn_torch.configs import presets as torch_presets
from heterofusionrcnn_torch.convert import load_flax_variables
from heterofusionrcnn_torch.datasets.kitti.dataset import KittiDataset
from heterofusionrcnn_torch.experiments import common, run_evaluation, run_training
from heterofusionrcnn_torch.runtime import evaluator
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager

from tests.rcnn_fixtures import write_handoff
from tests.test_torch_layers import as_jax, random_variables
from tools import plot_ap

STEP = 200
NUM_ROIS = 16
FINAL = f"final_predictions_and_scores/val/{STEP}/*.txt"
KITTI = f"kitti_native_eval/0.1/{STEP}/data/*.txt"
LEDGERS = {"rcnn_avg_losses.csv": 5, "rcnn_avg_cls_acc.csv": 2}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the tier-1 run has several workers a core
    set, and torch's spinning thread pools would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(presets):
    cfg = presets.rcnn_unittest()
    cfg.dataset_config.data_split = "val"
    cfg.dataset_config.aug_list = []
    cfg.model_config.path_drop_probabilities = [1.0, 1.0]
    return cfg


def _dataset(cls, cfg, dirs):
    ds = cls(cfg.dataset_config, "val")
    ds.proposal_dir, ds.proposal_iou_dir, ds.rpn_feature_dir = dirs
    return ds


def _variables(model, jds, ic):
    """Random flax variables whose BatchNorms hold the statistics of the
    first eval batch (2 frames): flax moves a statistic to 0.99 old + 0.01
    batch, so the batch's is recovered from one training apply."""
    batch, _, _ = next(j_evaluator._iter_eval_batches(
        jds, 2, "rcnn", lambda n: False, img_w=ic.img_dims_w, img_h=ic.img_dims_h,
        num_rois=NUM_ROIS))
    args = [jax.numpy.asarray(batch[k]) for k in common.RCNN_BATCH_KEYS]
    v = random_variables(lambda: model.init(jax.random.PRNGKey(0), *args, training=False), 23)
    rngs = {"dropout": jax.random.PRNGKey(1), "path_drop": jax.random.PRNGKey(2)}
    head = v["params"]["reg_output"]["Dense_0"]
    head["kernel"] = head["kernel"] * np.float32(0.1)
    head["bias"] = head["bias"] * np.float32(0.1)
    _, upd = jax.jit(lambda v_, *a: model.apply(v_, *a, training=True, mutable=["batch_stats"],
                                                rngs=rngs))(as_jax(v), *args)
    return dict(v, batch_stats=jax.tree_util.tree_map(
        lambda new, old: np.asarray((new - 0.99 * old) / 0.01), upd["batch_stats"],
        v["batch_stats"]))


@pytest.fixture(scope="module")
def eval_roots(tmp_path_factory):
    """The same weights through the JAX evaluator (batch 1) and the port's
    (batches 1 and 2) over one synthetic val handoff; also the port's
    weights and handoff for the watcher test. One torch thread, as the
    tests that compare with its files have (`_one_torch_thread`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg, tcfg = _config(jax_presets), _config(torch_presets)
    dirs = write_handoff(KittiDataset(tcfg.dataset_config, "val"),
                         str(tmp_path_factory.mktemp("handoff")))
    jds = _dataset(JaxKittiDataset, jcfg, dirs)
    model, _ = jax_common.build_model(jcfg, jds, "val")
    v = _variables(model, jds, jcfg.model_config.input_config)

    roots, summaries = {}, {}
    root = str(tmp_path_factory.mktemp("jax_rcnn_eval"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_pointcnn, "knn_point", _knn_reference_jnp)
        ev = j_evaluator.RcnnEvaluator(model, _dataset(JaxKittiDataset, jcfg, dirs), jcfg, root)
        summaries["jax"] = ev.run_checkpoint_once(v, STEP, num_rois=NUM_ROIS)
    roots["jax"] = os.path.join(root, "rcnn_unittest")

    tds = _dataset(KittiDataset, tcfg, dirs)
    ours, _ = common.build_model(tcfg, tds, "val")
    load_flax_variables(ours, v)
    for bs in (1, 2):
        root = str(tmp_path_factory.mktemp(f"torch_rcnn_eval_bs{bs}"))
        ev = evaluator.RcnnEvaluator(ours, _dataset(KittiDataset, tcfg, dirs), tcfg, root,
                                     eval_batch_size=bs)
        summaries[bs] = ev.run_checkpoint_once(None, STEP, num_rois=NUM_ROIS)
        roots[bs] = os.path.join(root, "rcnn_unittest")
    torch.set_num_threads(threads)
    return roots, summaries, dict(cfg=tcfg, dirs=dirs, state_dict=ours.state_dict())


def _kitti_rows(path):
    if os.path.getsize(path) == 0:
        return np.zeros((0, 15))
    return np.atleast_2d(np.genfromtxt(path, usecols=range(1, 16)))


def _same_row_sets(got, want, atol, name):
    """Rows of `got` matched one to one with rows of `want` (the pairing of
    least total difference), each pair within `atol`."""
    assert got.shape == want.shape, name
    if not len(got):
        return
    diff = np.abs(got[:, None, :] - want[None, :, :]).max(-1)
    rows, cols = linear_sum_assignment(diff)
    worst = diff[rows, cols].max()
    assert worst <= atol + 1e-9, (name, worst)  # 1e-9: the decimal -> binary parse


def _compare_trees(root_a, root_b, pattern, loader, atol):
    files = [sorted(glob.glob(os.path.join(r, "predictions", pattern))) for r in (root_a, root_b)]
    assert [os.path.basename(f) for f in files[0]] == [os.path.basename(f) for f in files[1]]
    assert len(files[0]) == 6, files[0]
    nonempty = 0
    for a, b in zip(*files):
        got, want = loader(a), loader(b)
        _same_row_sets(got, want, atol, os.path.basename(a))
        nonempty += len(got) > 0
    return nonempty


@pytest.mark.parametrize("other", ["jax", 2], ids=["jax_batch1", "port_batch2"])
@pytest.mark.parametrize("pattern,loader,atol", [
    (FINAL, lambda p: np.loadtxt(p, ndmin=2).reshape(-1, 9), 2e-5),
    (KITTI, _kitti_rows, 1e-2),
], ids=["final", "kitti"])
def test_rcnn_evaluator_files_match(eval_roots, other, pattern, loader, atol):
    """The port's batch-1 files against the JAX evaluator's and against the
    port's own batch-2 run."""
    roots, _, _ = eval_roots
    assert _compare_trees(roots[1], roots[other], pattern, loader, atol) >= 3
    if pattern == FINAL:
        for f in glob.glob(os.path.join(roots[1], "predictions", pattern)):
            rows = np.loadtxt(f, ndmin=2).reshape(-1, 9)
            assert np.isfinite(rows).all()
            assert (rows[:, 7] >= 0).all() and (rows[:, 7] <= 1).all()
            assert set(rows[:, 8].astype(int)) <= {0, 1, 2}
            assert (np.diff(rows[:, 7]) <= 0).all()


@pytest.mark.parametrize("other", ["jax", 2], ids=["jax_batch1", "port_batch2"])
def test_rcnn_evaluator_ledgers_match(eval_roots, other):
    """The reference-format ledgers row for row, the summaries' accuracy and
    losses, and the native evaluator's two AP summaries."""
    roots, summaries, _ = eval_roots
    for name, width in LEDGERS.items():
        got, want = (np.loadtxt(os.path.join(roots[k], "predictions", name), delimiter=",",
                                ndmin=2) for k in (1, other))
        assert got.shape == want.shape == (1, width), name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(summaries[1]["avg_cls_acc"], summaries[other]["avg_cls_acc"],
                               atol=1e-4)
    for key, val in summaries[other]["avg_losses"].items():
        assert summaries[1]["avg_losses"][key] == pytest.approx(val, rel=1e-4, abs=1e-4), key
    assert summaries[1]["avg_losses"]["rcnn_reg_loss"] > 0
    for sub in ("", "results_05_iou"):
        aps = [json.load(open(os.path.join(roots[k], "predictions", "kitti_native_eval", "0.1",
                                           str(STEP), sub, "ap_summary.json")))
               for k in (1, other)]
        assert len(aps[0]) == 12 and aps[0].keys() == aps[1].keys()
    for key in ("ap", "ap_05_iou"):
        assert set(summaries[1][key]) == set(summaries[other][key])
    with open(os.path.join(roots[1], "logs", "rcnn_eval.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["global_step", "avg_cls_acc", "avg_inference_time"]
    assert [int(r[0]) for r in rows[1:]] == [STEP]


def test_plot_ap_reads_the_port_summaries(eval_roots):
    """tools/plot_ap.py (package-free) finds the AP summary the port's
    evaluator writes under kitti_native_eval/<thresh>/<step>/ and reads it
    as written."""
    roots, summaries, _ = eval_roots
    parsed = plot_ap.parse_summaries(os.path.join(roots[1], "predictions"))
    assert list(parsed) == [STEP]
    assert parsed[STEP] == {k: tuple(v) for k, v in summaries[1]["ap"].items()}
    assert len(parsed[STEP]["car_detection_3d"]) == 3


def test_repeated_checkpoint_run_passes_num_rois(eval_roots, tmp_path, monkeypatch):
    """The watcher evaluates each checkpoint once with the caller's
    `num_rois` (what the one-shot path at 16 RoIs writes: the default 100
    would write other ledgers), stops at `stop_at_step`, and a second call
    evaluates nothing."""
    roots, _, setup = eval_roots
    monkeypatch.setattr(evaluator.time, "sleep", lambda s: None)
    cfg, dirs, sd = setup["cfg"], setup["dirs"], setup["state_dict"]
    root = str(tmp_path)
    mgr = CheckpointManager(os.path.join(root, "rcnn_unittest", "checkpoints"))
    for step in (STEP, STEP + 100):
        mgr.save(step, sd)
    model, _ = common.build_model(cfg, _dataset(KittiDataset, cfg, dirs), "val")
    ev = evaluator.RcnnEvaluator(model, _dataset(KittiDataset, cfg, dirs), cfg, root)
    calls = []
    once = ev.run_checkpoint_once
    monkeypatch.setattr(ev, "run_checkpoint_once",
                        lambda state, step, **kw: calls.append((step, kw)) or once(state, step, **kw))

    def make_state(step):
        return mgr.restore_raw(step)["state_dict"]

    for _ in range(2):
        evaluator.repeated_checkpoint_run(ev, mgr, make_state, "rcnn_eval.csv",
                                          stop_at_step=STEP + 100, num_rois=NUM_ROIS)
    assert calls == [(STEP, {"num_rois": NUM_ROIS}), (STEP + 100, {"num_rois": NUM_ROIS})]
    assert evaluator.evaluated_steps(ev.logs_dir, "rcnn_eval.csv") == {STEP, STEP + 100}
    mine = os.path.join(root, "rcnn_unittest")
    _compare_trees(mine, roots[1], FINAL, lambda p: np.loadtxt(p, ndmin=2).reshape(-1, 9), 0.0)
    for name in LEDGERS:
        got = np.loadtxt(os.path.join(mine, "predictions", name), delimiter=",", ndmin=2)
        want = np.loadtxt(os.path.join(roots[1], "predictions", name), delimiter=",", ndmin=2)
        np.testing.assert_array_equal(got[:, 1:], np.repeat(want[:, 1:], 2, axis=0))
    # The default of 100 RoIs a frame gives other ledgers, so the rows above
    # show that the watcher passed num_rois on.
    full = evaluator.RcnnEvaluator(model, _dataset(KittiDataset, cfg, dirs), cfg,
                                   str(tmp_path / "default")).run_checkpoint_once(sd, STEP)
    assert full["avg_losses"]["rcnn_cls_loss"] != pytest.approx(
        np.loadtxt(os.path.join(roots[1], "predictions", "rcnn_avg_losses.csv"),
                   delimiter=",")[1], abs=1e-4)


def test_two_stage_evaluation_clis(tmp_path, monkeypatch):
    """RPN training (2 steps), the RPN's evaluation over the val split
    through the watcher and over the train split as the handoff, RCNN
    training from the handoff (3 steps, checkpoints 2 and 3), then the RCNN's evaluation over the
    val handoff: one-shot of the latest checkpoint at 16 RoIs, then the
    watcher for the rest (tests/test_two_stage_pipeline.py's assertions)."""
    monkeypatch.setattr(evaluator.time, "sleep", lambda s: None)
    root = str(tmp_path)
    base = ["--device", "cpu", "--output_root", root]
    run_training.main(base + ["--pipeline_config", "rpn_unittest", "--max_iterations", "2"])
    rpn_pred = os.path.join(root, "rpn_unittest", "predictions")
    assert run_evaluation.main(base + ["--pipeline_config", "rpn_unittest", "--data_split", "val",
                                       "--save_rpn_feature", "--evaluate_repeatedly"]) == []
    with open(os.path.join(root, "rpn_unittest", "logs", "rpn_total_recall.csv")) as f:
        assert [int(r[0]) for r in list(csv.reader(f))[1:]] == [2]
    summaries = run_evaluation.main(base + ["--pipeline_config", "rpn_unittest", "--data_split",
                                            "train", "--save_rpn_feature", "--for_rcnn_train"])
    assert [s["global_step"] for s in summaries] == [2]

    def handoff(split):
        return [os.path.join(rpn_pred, d, split, "2")
                for d in ("proposals_and_scores", "proposals_iou", "rpn_feature")]

    def flags(dirs):
        return ["--proposal_dir", dirs[0], "--proposal_iou_dir", dirs[1],
                "--rpn_feature_dir", dirs[2]]

    run_training.main(base + ["--pipeline_config", "rcnn_unittest", "--max_iterations", "3",
                              "--warm_start_from", os.path.join(root, "rpn_unittest",
                                                                "checkpoints")]
                      + flags(handoff("train")))
    rcnn = os.path.join(root, "rcnn_unittest")
    assert CheckpointManager(os.path.join(rcnn, "checkpoints")).all_steps() == [2, 3]
    evals = base + ["--pipeline_config", "rcnn_unittest", "--data_split", "val",
                    "--num_rois", str(NUM_ROIS)] + flags(handoff("val"))
    summary, = run_evaluation.main(evals)
    assert run_evaluation.main(evals + ["--evaluate_repeatedly"]) == []
    with open(os.path.join(rcnn, "logs", "rcnn_eval.csv")) as f:
        assert [int(r[0]) for r in list(csv.reader(f))[1:]] == [3, 2]

    finals = sorted(glob.glob(os.path.join(rcnn, "predictions", "final_predictions_and_scores",
                                           "val", "3", "*.txt")))
    assert len(finals) == 6
    for f in finals:
        rows = np.loadtxt(f, ndmin=2).reshape(-1, 9)
        assert np.isfinite(rows).all()
        assert (rows[:, 7] >= 0).all() and (rows[:, 7] <= 1).all()
        assert set(rows[:, 8].astype(int)) <= {0, 1, 2}
    kitti = glob.glob(os.path.join(summary["kitti_predictions_dir"], "*.txt"))
    assert len(kitti) == 6
    for f in kitti:
        with open(f) as fh:
            for line in fh:
                parts = line.split()
                if parts:
                    assert len(parts) == 16 and parts[0] in ("Car", "Pedestrian", "Cyclist")
    losses = np.loadtxt(os.path.join(rcnn, "predictions", "rcnn_avg_losses.csv"), delimiter=",",
                        ndmin=2)
    assert losses.shape == (2, 5) and np.isfinite(losses).all()
    acc = np.loadtxt(os.path.join(rcnn, "predictions", "rcnn_avg_cls_acc.csv"), delimiter=",",
                     ndmin=2)
    assert acc.shape == (2, 2) and ((acc[:, 1] >= 0) & (acc[:, 1] <= 1)).all()
    assert np.isfinite(summary["avg_losses"]["rcnn_total_loss"])
    assert len(summary["ap"]) == len(summary["ap_05_iou"]) == 12
    ts = summary["inference_time_stats"]
    assert ts["min"] <= ts["median"] <= ts["max"]
