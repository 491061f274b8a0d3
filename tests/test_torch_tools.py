"""The port's workflow tools (`tools/torch_*.py`, `tools/convert_orbax_checkpoint.py`)
on the CPU.

- The converter: a JAX `rpn_unittest` state and an `rcnn_unittest` state
  with `use_moving_average` on, saved by the JAX `CheckpointManager` with
  their optimizer state filled from a seed, converted, then loaded into the
  port: the forwards against the JAX forwards at the tolerances of
  tests/test_torch_models.py, every moment, the count and the EMA equal to
  the JAX leaves under their parameter's layout map, and one port Adam step
  against optax's `update` + `apply_updates` on the same seeded gradients
  within 1e-6.
- `torch_run_full_pipeline` at `rpn_unittest` / `rcnn_unittest`, 2 + 2
  iterations, against the four port CLIs run by hand with the same flags
  and seeds: checkpoints, handoff files, predictions and ap_summary.json
  equal bit for bit.
- `torch_run_eval_sweep`: every RCNN checkpoint evaluated once, nothing on
  a rerun.
- `torch_run_generalization`: 2 + 2 iterations, a checkpoint a step, both
  curves with the JAX tool's headers, and summary.json.
- `torch_gen_label_segs` byte-equal to the JAX tool's `_process_sample` on
  every fixture train frame; `torch_gen_label_clusters` the JAX tool's
  caches and means.

The pipeline and the generalization tool run on splits of two fixture
frames each (train 000000 and 000003, val 000001 and 000002). The pipeline
test runs on one intra-op thread: with several, the CPU's backward
reductions are not bit-repeatable from run to run (two identical RPN
trainings in one process differ in the last bits of their moments). The
sweep and generalization tests do too, as they run alone no slower and
among parallel test workers much faster.
"""

from __future__ import annotations

import ast
import csv
import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from heterofusionrcnn_tpu.configs import presets as jax_presets
from heterofusionrcnn_tpu.configs.config import save_config as jax_save_config
from heterofusionrcnn_tpu.runtime.checkpoint import CheckpointManager as OrbaxManager
from heterofusionrcnn_tpu.runtime.optimizer import ParamEmaState, build_optimizer
from heterofusionrcnn_tpu.runtime.train_state import TrainState

from heterofusionrcnn_torch.configs import presets as torch_presets
from heterofusionrcnn_torch.convert import flax_to_state_dict
from heterofusionrcnn_torch.experiments import common, run_evaluation, run_training
from heterofusionrcnn_torch.inference import CLUSTER_SIZES
from heterofusionrcnn_torch.models.extractors.layers import init_weights
from heterofusionrcnn_torch.models.rcnn import RcnnModel
from heterofusionrcnn_torch.models.rpn import RpnModel
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
from heterofusionrcnn_torch.runtime.optimizer import Optimizer
from heterofusionrcnn_torch.utils import format_checker

from tests.rcnn_fixtures import write_handoff
from tests.test_torch_layers import direct_knn
from tests.test_torch_models import TOL, _inputs, _rcnn_jax, _rpn_jax
from tools import convert_orbax_checkpoint as converter
from tools import gen_label_clusters as j_gen_label_clusters
from tools import gen_label_segs as j_gen_label_segs
from tools import (torch_gen_label_clusters, torch_gen_label_segs, torch_run_eval_sweep,
                   torch_run_full_pipeline, torch_run_generalization)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "kitti"
MINI_TRAIN, MINI_VAL = ("000000", "000003"), ("000001", "000002")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _mini_dataset(root: Path) -> str:
    """The fixture's frames with splits mini_train and mini_val of two
    frames each (the clusters still come from its train split)."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "training").symlink_to(FIXTURE / "training")
    for split in ("train", "val"):
        (root / f"{split}.txt").write_text((FIXTURE / f"{split}.txt").read_text())
    (root / "mini_train.txt").write_text("\n".join(MINI_TRAIN) + "\n")
    (root / "mini_val.txt").write_text("\n".join(MINI_VAL) + "\n")
    return str(root)


# ------------------------------------------------------------------ converter


def _layout(path, leaf):
    """A flax leaf in the port's layout: Dense kernels transposed, Conv
    kernels HWIO -> OIHW, ConvTranspose kernels flipped in H and W and
    permuted to (I, O, H, W); everything else as it is."""
    arr = np.asarray(leaf, np.float32)
    if path[-1] != "kernel":
        return arr
    if path[-2] == "Conv_0":
        return arr.transpose(3, 2, 0, 1)
    if path[-2] == "ConvTranspose_0":
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    return arr.T


def _port_name(path):
    renames = {"kernel": "weight", "scale": "weight"}
    return ".".join(path[:-1] + (renames.get(path[-1], path[-1]),))


def _named_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(k.key for k in path), leaf) for path, leaf in flat]


def _seeded_opt_state(tx, params, seed):
    """tx.init(params) with seeded moments, count 5 and an EMA near params."""
    rng = np.random.default_rng(seed)
    fill = lambda f: jax.tree_util.tree_map(  # noqa: E731
        lambda p: jnp.asarray(f(p.shape).astype(np.float32)), params)
    clip, (adam, sched), *ema = tx.init(params)
    count = jnp.asarray(5, jnp.int32)
    adam = adam._replace(count=count, mu=fill(lambda s: rng.normal(0, 1e-2, s)),
                         nu=fill(lambda s: rng.uniform(1e-6, 1e-4, s)))
    ema = [ParamEmaState(ema=jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(0, 1e-3, p.shape).astype(np.float32)), params))
        for _ in ema]
    return (clip, (adam, sched._replace(count=count)), *ema)


_jax_rpn = functools.lru_cache(maxsize=1)(_rpn_jax)


def _convert(root: Path, stage: str):
    """The JAX `stage` saved by orbax with a seeded optimizer state
    (`rcnn_unittest` with the EMA on, from a saved JSON config), then
    converted: (its TrainState, its optax chain, its outputs on `_inputs()`,
    the port checkpoint, the port config, the JAX RPN's outputs)."""
    rpn_v, rpn_out = _jax_rpn()
    if stage == "rpn":
        v, want, cfg, name, step = rpn_v, rpn_out, jax_presets.rpn_unittest(), "rpn_unittest", 5
    else:
        v, want = _rcnn_jax(rpn_out, False)
        cfg = jax_presets.rcnn_unittest()
        cfg.model_config.checkpoint_name = "rcnn_unittest_ema"
        cfg.train_config.optimizer.use_moving_average = True
        name, step = str(root / "rcnn_unittest_ema.json"), 7
        jax_save_config(cfg, name)
    tc = cfg.train_config
    tx = build_optimizer(tc.optimizer, grad_clip_norm=tc.grad_clip_norm)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = TrainState(step=jnp.asarray(step, jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
                       opt_state=_seeded_opt_state(tx, params, step), tx=tx, apply_fn=None)
    mgr = OrbaxManager(str(root / "orbax"))
    mgr.save(step, state)
    mgr.close()
    path = converter.main(["--pipeline_config", name, "--orbax_dir", str(root / "orbax"),
                           "--out_dir", str(root / "port")])
    ckpt = torch.load(path, weights_only=True)
    assert ckpt["step"] == step
    return state, tx, want, ckpt, common.resolve_config(name), rpn_out


def _port_model(stage, cfg, ckpt):
    model = (RpnModel(cfg.model_config, 3, CLUSTER_SIZES) if stage == "rpn"
             else RcnnModel(cfg.model_config, 3, CLUSTER_SIZES, 64 + 8))
    model.load_state_dict(ckpt["state_dict"])
    return model.eval()


def _check_forward(model, stage, want, rpn_out):
    """The converted model's test-mode forward against JAX's."""
    b = {k: torch.from_numpy(x) for k, x in _inputs().items()}
    with torch.no_grad():
        if stage == "rpn":
            got = model(b["point_cloud"], b["image_input"], b["stereo_calib_p2"])
        else:
            t = {k: torch.from_numpy(np.array(x)) for k, x in rpn_out.items()}
            got = model(t["proposals"], t["rpn_pts"], t["rpn_intensity"][..., 0],
                        t["foreground_mask"].float(),
                        torch.cat([t["rpn_fts"], t["rpn_img_fts"]], -1),
                        b["image_input"], b["stereo_calib_p2"])
    if stage == "rpn":
        for key in ("seg_softmax", "rpn_fts", "rpn_img_fts", "proposal_scores", "proposals"):
            _close(got[key], want[key])
        np.testing.assert_array_equal(got["foreground_mask"].numpy(), want["foreground_mask"])
        np.testing.assert_array_equal(got["num_proposals_before_padding"].numpy(),
                                      want["num_proposals_before_padding"])
    else:
        np.testing.assert_array_equal(got["nms_indices"].numpy(), want["nms_indices"])
        _close(got["cls_softmax"], want["cls_softmax"])
        _close(got["final_scores"], want["final_scores"])
        _close(got["final_boxes"], want["final_boxes"], rtol=1e-4, atol=5e-4)


def _check_optimizer_state(model, state, ckpt, cfg):
    """Every moment, the count and the EMA equal to the JAX leaves under
    their parameter's layout map; every parameter and buffer converted."""
    opt = ckpt["optimizer"]
    _, (adam, sched), *ema = state.opt_state
    assert opt["count"] == int(adam.count) == int(sched.count) == 5
    assert set(opt["state"]) == {"mu", "nu"}
    assert ("ema" in opt) == cfg.train_config.optimizer.use_moving_average == bool(ema)
    trees = {"mu": adam.mu, "nu": adam.nu, **({"ema": ema[0].ema} if ema else {})}
    for key, tree in trees.items():
        got = opt["ema"] if key == "ema" else opt["state"][key]
        leaves = _named_leaves(tree)
        assert set(got) == {_port_name(p) for p, _ in leaves}
        for path, leaf in leaves:
            name = _port_name(path)
            assert got[name].shape == ckpt["state_dict"][name].shape
            np.testing.assert_array_equal(got[name].numpy(), _layout(path, leaf),
                                          err_msg=f"{key} {name}")
    assert set(ckpt["state_dict"]) == set(model.state_dict())
    assert set(opt["state"]["mu"]) == {n for n, _ in model.named_parameters()}


def _check_resume(model, state, tx, ckpt, cfg):
    """One port Adam step (clip, schedule at count 5, bias corrections at
    6, EMA) from the converted checkpoint against optax from the orbax
    state, on the same seeded gradients."""
    rng = np.random.default_rng(11)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(0, 0.05, p.shape).astype(np.float32)), state.params)

    @jax.jit
    def optax_step(g, opt_state, params):
        updates, new_opt = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), new_opt

    new_params, new_opt = optax_step(grads, state.opt_state, state.params)
    want = flax_to_state_dict(jax.device_get(new_params))
    opt = Optimizer(model.named_parameters(), cfg.train_config.optimizer,
                    grad_clip_norm=cfg.train_config.grad_clip_norm)
    opt.load_state_dict(ckpt["optimizer"])
    g = flax_to_state_dict(jax.device_get(grads))
    opt.step([g[n] for n in opt.names])
    assert opt.count == 6
    got = dict(model.named_parameters())
    for name in opt.names:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name], rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    _, (adam, _), *ema = new_opt
    for key, tree in (("mu", adam.mu), ("nu", adam.nu)):
        w = flax_to_state_dict(jax.device_get(tree))
        for name, t in zip(opt.names, opt.state[key]):
            np.testing.assert_allclose(t.numpy(), w[name], rtol=1e-6, atol=1e-6)
    if ema:
        w = flax_to_state_dict(jax.device_get(ema[0].ema))
        for name, t in opt.ema_state_dict().items():
            np.testing.assert_allclose(t.numpy(), w[name], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stage", ["rpn", "rcnn"])
def test_converted_checkpoint_matches_jax(tmp_path, monkeypatch, stage):
    """The converter's checkpoint of `stage`: the forward, the optimizer
    state and the next Adam step against JAX's (one test a stage, so that
    the JAX models are built once)."""
    direct_knn(monkeypatch)
    state, tx, want, ckpt, cfg, rpn_out = _convert(tmp_path, stage)
    model = _port_model(stage, cfg, ckpt)
    _check_forward(model, stage, want, rpn_out)
    _check_optimizer_state(model, state, ckpt, cfg)
    _check_resume(model, state, tx, ckpt, cfg)


# ------------------------------------------------------------------- pipeline


def _tree_files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _assert_same_checkpoints(a: Path, b: Path):
    steps = CheckpointManager(str(a)).all_steps()
    assert steps and steps == CheckpointManager(str(b)).all_steps()
    for step in steps:
        got = CheckpointManager(str(a)).restore_raw(step)
        want = CheckpointManager(str(b)).restore_raw(step)
        assert got["step"] == want["step"] == step

        def same(x, y):
            if isinstance(x, torch.Tensor):
                return x.dtype == y.dtype and torch.equal(x, y)
            if isinstance(x, dict):
                return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
            return x == y

        assert same(got, want), f"checkpoint {step} of {a}"


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_full_pipeline_equals_the_four_clis(tmp_path, one_thread):
    data = _mini_dataset(tmp_path / "data")
    tool_root, hand_root = tmp_path / "tool", tmp_path / "hand"
    summary = torch_run_full_pipeline.main([
        "--rpn_config", "rpn_unittest", "--rcnn_config", "rcnn_unittest", "--dataset_dir", data,
        "--output_root", str(tool_root), "--train_split", "mini_train", "--eval_split",
        "mini_val", "--rpn_iterations", "2", "--rcnn_iterations", "2", "--num_rois", "16",
        "--seed", "3", "--device", "cpu"])
    assert summary["rpn_step"] == summary["rcnn_step"] == 2
    assert set(summary["stage_s"]) == {"rpn_train", "rpn_handoff", "rcnn_train", "rcnn_eval"}
    assert set(summary["recall"]) == {"mini_train", "mini_val"}

    # The same four stages by hand.
    common_flags = ["--dataset_dir", data, "--output_root", str(hand_root), "--device", "cpu"]
    run_training.main(["--pipeline_config", "rpn_unittest", "--data_split", "mini_train",
                       "--seed", "3", "--max_iterations", "2", *common_flags])
    pred = hand_root / "rpn_unittest" / "predictions"
    for split in ("mini_train", "mini_val"):
        run_evaluation.main(["--pipeline_config", "rpn_unittest", "--data_split", split,
                             "--ckpt_indices", "2", "--save_rpn_feature", "--for_rcnn_train",
                             *common_flags])

    def dirs(split):
        return ["--proposal_dir", str(pred / "proposals_and_scores" / split / "2"),
                "--proposal_iou_dir", str(pred / "proposals_iou" / split / "2"),
                "--rpn_feature_dir", str(pred / "rpn_feature" / split / "2")]

    run_training.main(["--pipeline_config", "rcnn_unittest", "--data_split", "mini_train",
                       "--seed", "4", "--max_iterations", "2", "--warm_start_from",
                       str(hand_root / "rpn_unittest" / "checkpoints"), *dirs("mini_train"),
                       *common_flags])
    run_evaluation.main(["--pipeline_config", "rcnn_unittest", "--data_split", "mini_val",
                         "--ckpt_indices", "2", "--num_rois", "16", *dirs("mini_val"),
                         *common_flags])

    for name in ("rpn_unittest", "rcnn_unittest"):
        _assert_same_checkpoints(tool_root / name / "checkpoints", hand_root / name / "checkpoints")
        a, b = tool_root / name / "predictions", hand_root / name / "predictions"
        files = _tree_files(a)
        assert files == _tree_files(b)
        for rel in files:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    files = _tree_files(tool_root / "rcnn_unittest" / "predictions")
    assert {"kitti_native_eval/0.1/2/ap_summary.json",
            "kitti_native_eval/0.1/2/results_05_iou/ap_summary.json"} <= set(files)
    # The handoff and final prediction files pass the ported format checks.
    for rel in _tree_files(tool_root / "rpn_unittest" / "predictions"):
        if rel.startswith("proposals_and_scores/"):
            format_checker.check_proposal_file_format(
                np.loadtxt(tool_root / "rpn_unittest" / "predictions" / rel, ndmin=2))
    finals = [r for r in files if r.startswith("final_predictions_and_scores/")]
    assert len(finals) == len(MINI_VAL)
    for rel in finals:
        format_checker.check_final_prediction_file_format(
            np.loadtxt(tool_root / "rcnn_unittest" / "predictions" / rel, ndmin=2))


def test_eval_sweep_evaluates_each_step_once(tmp_path, one_thread):
    """Two RCNN checkpoints over a synthetic handoff of the val split: both
    evaluated, each with its AP files; a second run evaluates nothing."""
    cfg = torch_presets.rcnn_unittest()
    cfg.dataset_config.dataset_dir = str(FIXTURE)
    ds = common.build_dataset(cfg, "val", "val")
    handoff = write_handoff(ds, str(tmp_path / "handoff"))
    ckpts = CheckpointManager(str(tmp_path / "out" / "rcnn_unittest" / "checkpoints"))
    for step in (1, 2):
        model, _ = common.build_model(cfg, ds, "train")
        ckpts.save(step, init_weights(model, step))
    argv = ["--pipeline_config", "rcnn_unittest", "--dataset_dir", str(FIXTURE),
            "--output_root", str(tmp_path / "out"), "--num_rois", "16", "--device", "cpu",
            "--proposal_dir", handoff[0], "--proposal_iou_dir", handoff[1],
            "--rpn_feature_dir", handoff[2]]
    first = torch_run_eval_sweep.main(argv)
    assert sorted(step for step, _ in first) == [1, 2]
    assert [ap for _, ap in first] == sorted((ap for _, ap in first), reverse=True)
    kitti = tmp_path / "out" / "rcnn_unittest" / "predictions" / "kitti_native_eval" / "0.1"
    for step in (1, 2):
        assert (kitti / str(step) / "ap_summary.json").is_file()
    ledger = tmp_path / "out" / "rcnn_unittest" / "logs" / "rcnn_eval.csv"
    rows = ledger.read_text()
    assert torch_run_eval_sweep.main(argv) == []
    assert ledger.read_text() == rows
    assert sorted(int(r[0]) for r in list(csv.reader(rows.splitlines()))[1:]) == [1, 2]


# ------------------------------------------------------------ generalization


def _jax_tool_headers(path: Path):
    """The header lists of the `_write_csv` calls in a JAX tool's source."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_write_csv":
            out.append(ast.literal_eval(node.args[1]))
    return out


def test_generalization_writes_curves_and_summary(tmp_path, one_thread):
    data = _mini_dataset(tmp_path / "data")
    out = tmp_path / "gen"
    summary = torch_run_generalization.main([
        "--rpn_config", "rpn_unittest", "--rcnn_config", "rcnn_unittest", "--dataset_dir", data,
        "--output_root", str(out), "--train_split", "mini_train", "--eval_split", "mini_val",
        "--rpn_iterations", "2", "--rcnn_iterations", "2", "--checkpoint_interval", "1",
        "--num_rois", "16", "--device", "cpu"])
    gen = out / "generalization"
    rpn_header, rcnn_header = _jax_tool_headers(ROOT / "tools" / "run_generalization.py")
    for name, header in (("rpn_recall_curve.csv", rpn_header), ("rcnn_ap_curve.csv", rcnn_header)):
        rows = list(csv.reader((gen / name).read_text().splitlines()))
        assert rows[0] == header
        assert [int(float(r[0])) for r in rows[1:]] == [1, 2]
        assert all(np.isfinite(float(x)) for r in rows[1:] for x in r)
    written = json.loads((gen / "summary.json").read_text())
    assert set(written) == {"train_split", "eval_split", "rpn_steps", "rcnn_steps",
                            "val_recall_curve", "val_ap_final", "train_ap_final"}
    assert written["rpn_steps"] == written["rcnn_steps"] == 2
    assert len(written["val_recall_curve"]) == 2
    assert "car_detection_3d" in written["val_ap_final"]
    assert "car_detection_3d" in written["train_ap_final"]
    assert written == json.loads(json.dumps(summary, default=list))
    # The configs the trainings ran, with the checkpoint interval applied.
    cfg = common.resolve_config(str(gen / "configs" / "rcnn_unittest.json"))
    assert cfg.train_config.checkpoint_interval == 1 and cfg.train_config.max_iterations == 2
    # The handoff under its own root; a rerun from it evaluates nothing new.
    assert (out / "handoff" / ".done_mini_train_2").is_file()
    again = torch_run_generalization.main([
        "--rpn_config", "rpn_unittest", "--rcnn_config", "rcnn_unittest", "--dataset_dir", data,
        "--output_root", str(out), "--train_split", "mini_train", "--eval_split", "mini_val",
        "--rpn_iterations", "2", "--rcnn_iterations", "2", "--checkpoint_interval", "1",
        "--num_rois", "16", "--device", "cpu", "--resume_from_handoff"])
    assert again["rcnn_steps"] == 2 and again["val_recall_curve"] == [
        [str(x) for x in row] for row in summary["val_recall_curve"]]
    assert again["val_ap_final"] == summary["val_ap_final"]
    assert again["train_ap_final"] == summary["train_ap_final"]


# ---------------------------------------------------------------- label tools


def test_gen_label_segs_matches_the_jax_tool(tmp_path):
    names = (FIXTURE / "train.txt").read_text().split()
    done = torch_gen_label_segs.main(["--dataset_dir", str(FIXTURE), "--out_dir",
                                      str(tmp_path / "port"), "--workers", "2"])
    assert sorted(done) == sorted(names)
    (tmp_path / "jax").mkdir()
    classes = ("Car", "Pedestrian", "Cyclist")
    for name in names:
        _, fg = j_gen_label_segs._process_sample(
            (str(FIXTURE), str(tmp_path / "jax"), name, classes, 0.2))
        assert done[name] == fg
        got = (tmp_path / "port" / f"{name}.npy").read_bytes()
        assert got == (tmp_path / "jax" / f"{name}.npy").read_bytes(), name
    assert sum(done.values()) > 0
    # An existing file is kept.
    assert set(torch_gen_label_segs.main(["--dataset_dir", str(FIXTURE), "--out_dir",
                                          str(tmp_path / "port"), "--workers", "1"]).values()) == {0}


def test_gen_label_clusters_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    argv = ["--dataset_dir", str(FIXTURE), "--cluster_split", "train", "--num_clusters", "1", "2",
            "1"]
    clusters, stds = torch_gen_label_clusters.main(argv + ["--cache_dir", str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["gen_label_clusters.py", *argv,
                                      "--cache_dir", str(tmp_path / "jax")])
    j_gen_label_clusters.main()
    assert capsys.readouterr().out == port_out
    files = _tree_files(tmp_path / "port")
    assert len(files) == 3 and files == _tree_files(tmp_path / "jax")
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    assert [c.shape for c in clusters] == [(1, 3), (2, 3), (1, 3)]
    assert all(np.isfinite(s).all() for s in stds)
