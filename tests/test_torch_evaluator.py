"""The port's RPN evaluator and the two-stage training CLIs on the CPU.

- `RpnEvaluator` at `rpn_unittest` on the fixture train split (val mode,
  features saved) writes the same file trees as the JAX package's
  evaluator from the same weights: proposal rows within 1e-3 (both sides
  write %.3f, so a last-digit rounding flip is one unit), 3D-IoU tables and
  feature files within 1e-4, and the three reference-format ledgers (losses,
  seg accuracy, recall) row for row within 1e-4. The port runs batches of 2
  (the last one padded), the JAX evaluator batches of 1.
- `run_evaluation --save_rpn_feature --for_rcnn_train` after one RPN
  train step, then `run_training --pipeline_config rcnn_unittest
  --warm_start_from ... --proposal_dir ...`: 3 steps, a resume to 4.
- The options that are not given raise: the RCNN's training and
  evaluation without the handoff directories.

Weights are flax variables drawn from a seed (tests/test_torch_layers.py),
carried into the port by `heterofusionrcnn_torch.convert`; the proposal
head's kernel and bias are scaled by 0.1, so that every decoded box has a
positive size (random weights otherwise decode boxes of ~0 or negative
size, whose IoU divides by a clamped ~0 union on both sides and comes out
arbitrary). The JAX PointCNN takes the direct-distance KNN
(tests/test_torch_layers.py).
"""

from __future__ import annotations

import csv
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax

from heterofusionrcnn_tpu.configs import presets as jax_presets
from heterofusionrcnn_tpu.datasets.kitti.dataset import KittiDataset as JaxKittiDataset
from heterofusionrcnn_tpu.models.extractors import pointcnn as j_pointcnn
from heterofusionrcnn_tpu.models.rpn import RpnModel as JaxRpn
from heterofusionrcnn_tpu.ops.pallas_knn import _knn_reference_jnp
from heterofusionrcnn_tpu.runtime.evaluator import RpnEvaluator as JaxRpnEvaluator

from heterofusionrcnn_torch.configs import presets as torch_presets
from heterofusionrcnn_torch.convert import load_flax_variables
from heterofusionrcnn_torch.datasets.kitti.dataset import KittiDataset
from heterofusionrcnn_torch.experiments import run_evaluation, run_training
from heterofusionrcnn_torch.inference import CLUSTER_SIZES
from heterofusionrcnn_torch.models.rpn import RpnModel
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
from heterofusionrcnn_torch.runtime.evaluator import RpnEvaluator

from tests.test_torch_layers import random_variables

STEP = 100
LEDGERS = ("rpn_avg_losses.csv", "rpn_avg_seg_acc.csv", "rpn_total_recall.csv")
RCNN_METRIC_KEYS = {
    "step", "rcnn_cls_loss", "rcnn_bin_cls_loss", "rcnn_reg_loss", "total_loss",
    "steps_per_sec", "device_mem_mb", "host_rss_mb",
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the tier-1 run has several workers a core
    set, and torch's spinning thread pools would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eval_config(presets):
    cfg = presets.rpn_unittest()
    cfg.dataset_config.data_split = "train"
    cfg.model_config.path_drop_probabilities = [1.0, 1.0]
    return cfg


@pytest.fixture(scope="module")
def eval_roots(tmp_path_factory):
    """The same weights through the JAX and the port's RPN evaluator
    (val mode, features saved) into two output roots."""
    jcfg, tcfg = _eval_config(jax_presets), _eval_config(torch_presets)
    jds = JaxKittiDataset(jcfg.dataset_config, "val")
    model = JaxRpn(config=jcfg.model_config, num_classes=3, cluster_sizes=CLUSTER_SIZES,
                   mode="val", save_rpn_feature=True)
    ic = jcfg.model_config.input_config
    batch, _ = jds.next_batch(1, shuffle=False, model="rpn", pc_sample_pts=ic.pc_sample_pts,
                              img_w=ic.img_dims_w, img_h=ic.img_dims_h)
    args = [batch[k] for k in ("point_cloud", "image_input", "stereo_calib_p2", "label_seg",
                               "label_reg", "label_boxes_3d")]
    v = random_variables(lambda: model.init(jax.random.PRNGKey(0), *args, training=False), 17)
    head = v["params"]["fc_output"]["Dense_0"]
    head["kernel"] = head["kernel"] * np.float32(0.1)
    head["bias"] = head["bias"] * np.float32(0.1)

    roots, summaries = {}, {}
    root = str(tmp_path_factory.mktemp("jax_eval"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_pointcnn, "knn_point", _knn_reference_jnp)
        ev = JaxRpnEvaluator(model, JaxKittiDataset(jcfg.dataset_config, "val"), jcfg, root,
                             save_rpn_feature=True, eval_batch_size=1)
        summaries["jax"] = ev.run_checkpoint_once(v, STEP)
    roots["jax"] = os.path.join(root, "rpn_unittest")

    root = str(tmp_path_factory.mktemp("torch_eval"))
    ours = RpnModel(tcfg.model_config, 3, CLUSTER_SIZES, save_rpn_feature=True, mode="val")
    load_flax_variables(ours, v)
    ev = RpnEvaluator(ours, KittiDataset(tcfg.dataset_config, "val"), tcfg, root,
                      save_rpn_feature=True, eval_batch_size=2)
    summaries["torch"] = ev.run_checkpoint_once(None, STEP)
    roots["torch"] = os.path.join(root, "rpn_unittest")
    return roots, summaries


def _trees(roots, pattern, loader):
    files = {k: sorted(glob.glob(os.path.join(r, "predictions", pattern)))
             for k, r in roots.items()}
    names = [[os.path.basename(f) for f in fs] for fs in files.values()]
    assert names[0] == names[1] and len(names[0]) == 7, names
    return [(loader(a), loader(b), os.path.basename(a))
            for a, b in zip(files["torch"], files["jax"])]


@pytest.mark.parametrize("kind,pattern,atol", [
    ("proposals", f"proposals_and_scores/train/{STEP}/*.txt", 1e-3 + 1e-6),
    ("iou", f"proposals_iou/train/{STEP}/*.txt", 1e-4),
    ("features", f"rpn_feature/train/{STEP}/*.npy", 1e-4),
])
def test_rpn_evaluator_files_match_jax(eval_roots, kind, pattern, atol):
    roots, _ = eval_roots
    loader = np.load if kind == "features" else (lambda p: np.loadtxt(p, ndmin=2))
    for got, want, name in _trees(roots, pattern, loader):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
        if kind == "features":
            assert got.dtype == want.dtype == np.float32
            assert got.shape[1] == 5 + 64 + 8
        if kind == "proposals":
            assert got.shape == (64, 8) and (got[:, 3:6] > 0).all()


def test_rpn_evaluator_ledgers_match_jax(eval_roots):
    """The reference-format ledgers row for row, the summaries and the
    headed recall CSV under logs/ (its timing column aside)."""
    roots, summaries = eval_roots
    for name in LEDGERS:
        got, want = (np.loadtxt(os.path.join(roots[k], "predictions", name), delimiter=",",
                                ndmin=2) for k in ("torch", "jax"))
        assert got.shape == want.shape == (1, {"rpn_avg_losses.csv": 5,
                                               "rpn_avg_seg_acc.csv": 2}.get(name, 7)), name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=name)
    for key in ("avg_seg_acc", "recall_50", "recall_70", "avg_num_proposals", "avg_iou2d",
                "avg_iou3d", "avg_angle_res"):
        np.testing.assert_allclose(summaries["torch"][key], summaries["jax"][key], atol=1e-4,
                                   err_msg=key)
    for key, val in summaries["jax"]["avg_losses"].items():
        assert summaries["torch"]["avg_losses"][key] == pytest.approx(val, rel=1e-5, abs=1e-4)
    assert summaries["jax"]["avg_iou3d"] > 0
    rows = {}
    for k in ("torch", "jax"):
        with open(os.path.join(roots[k], "logs", "rpn_total_recall.csv")) as f:
            rows[k] = list(csv.reader(f))
    assert rows["torch"][0] == rows["jax"][0]
    keep = [i for i, h in enumerate(rows["jax"][0]) if h != "avg_inference_time"]
    np.testing.assert_allclose([float(rows["torch"][1][i]) for i in keep],
                               [float(rows["jax"][1][i]) for i in keep], rtol=0, atol=1e-4)


def test_two_stage_training_clis(tmp_path, capsys):
    """One RPN train step, its evaluation into the handoff files, then the
    RCNN's training from them, warm-started from the RPN: 3 steps, then a
    resume to 4."""
    root = str(tmp_path)
    run_training.main(["--device", "cpu", "--pipeline_config", "rpn_unittest", "--output_root",
                       root, "--max_iterations", "1"])
    summaries = run_evaluation.main(["--device", "cpu", "--pipeline_config", "rpn_unittest",
                                     "--output_root", root, "--data_split", "train",
                                     "--save_rpn_feature", "--for_rcnn_train"])
    assert [s["global_step"] for s in summaries] == [1]
    pred = os.path.join(root, "rpn_unittest", "predictions")
    dirs = [os.path.join(pred, d, "train", "1")
            for d in ("proposals_and_scores", "proposals_iou", "rpn_feature")]
    frames = [sorted(os.path.splitext(f)[0] for f in os.listdir(d)) for d in dirs]
    assert frames[0] == frames[1] == frames[2] and len(frames[0]) == 7
    for f in glob.glob(os.path.join(dirs[2], "*.npy")):
        arr = np.load(f)
        assert arr.shape == (2048, 5 + 64 + 8) and np.isfinite(arr).all()
    # --for_rcnn_train: the train NMS sizes (64 proposals at rpn_unittest).
    assert all(np.loadtxt(f).shape == (64, 8) for f in glob.glob(os.path.join(dirs[0], "*.txt")))

    rpn_ckpt = os.path.join(root, "rpn_unittest", "checkpoints")
    argv = ["--device", "cpu", "--pipeline_config", "rcnn_unittest", "--output_root", root,
            "--warm_start_from", rpn_ckpt, "--proposal_dir", dirs[0],
            "--proposal_iou_dir", dirs[1], "--rpn_feature_dir", dirs[2]]
    state = run_training.main(argv)
    assert state.step == 3 and state.optimizer.count == 3
    ckpt = CheckpointManager(os.path.join(root, "rcnn_unittest", "checkpoints"))
    assert ckpt.all_steps() == [2, 3]
    resumed = run_training.main(argv + ["--max_iterations", "4"])
    assert "Resumed from step 3" in capsys.readouterr().out
    assert resumed.step == 4 and ckpt.all_steps() == [2, 3, 4]
    with open(os.path.join(root, "rcnn_unittest", "logs", "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines] == [1, 2, 3, 4]
    for r in lines:
        assert set(r) == RCNN_METRIC_KEYS
        assert all(np.isfinite(v) for v in r.values())
    # The warm start: the image branch came from the RPN and moved by a
    # few Adam steps of ~lr each; the stage-2 PointCNN did not exist there.
    rpn_sd = CheckpointManager(rpn_ckpt).restore_raw()["state_dict"]
    got = resumed.model.state_dict()
    w = "img_vgg_pyr.conv1_1.Conv_0.weight"
    assert float((got[w] - rpn_sd[w]).abs().max()) < 0.01
    assert got["pc_pointcnn.xconv_1.fts_conv.depthwise"].shape != rpn_sd[
        "pc_pointcnn.xconv_1.fts_conv.depthwise"].shape


@pytest.mark.parametrize("cli,argv,exc,match", [
    ("train", ["--pipeline_config", "rcnn_unittest"], ValueError, "--proposal_dir"),
    ("train", ["--pipeline_config", "rcnn_unittest", "--proposal_dir", "p",
               "--proposal_iou_dir", "i"], ValueError, "--rpn_feature_dir"),
    ("eval", ["--pipeline_config", "rcnn_unittest", "--proposal_iou_dir", "i",
              "--rpn_feature_dir", "f"], ValueError, "--proposal_dir"),
    ("eval", ["--pipeline_config", "rcnn_unittest", "--evaluate_repeatedly", "--proposal_dir",
              "p", "--proposal_iou_dir", "i"], ValueError, "--rpn_feature_dir"),
])
def test_unported_or_missing_options_raise(tmp_path, cli, argv, exc, match):
    main = run_training.main if cli == "train" else run_evaluation.main
    with pytest.raises(exc, match=match):
        main(["--device", "cpu", "--output_root", str(tmp_path)] + argv)


def test_evaluation_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_evaluation.main(["--pipeline_config", "rpn_unittest", "--output_root", str(tmp_path)])
