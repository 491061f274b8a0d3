"""The port's training CLI (`heterofusionrcnn_torch.experiments.
run_training`) and trainer on the CPU: `rpn_unittest` on the fixture
frames, checkpoints, the metrics file, resume, the host-RSS cap, warm
start, and the options that cannot run (a world size that does not divide
the global batch, an RCNN config without its handoff directories) raising.

The JAX trainer (heterofusionrcnn_tpu/runtime/trainer.py) logs the train
step's metrics (the three RPN losses, total_loss, seg_accuracy) plus
steps_per_sec, device_mem_mb and host_rss_mb under "step"; the port's
metrics.jsonl must have the same keys.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from heterofusionrcnn_torch.configs.config import save_config
from heterofusionrcnn_torch.configs.presets import rpn_unittest
from heterofusionrcnn_torch.experiments import common, run_inference, run_training
from heterofusionrcnn_torch.inference import CLUSTER_SIZES
from heterofusionrcnn_torch.models.rpn import RpnModel
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager, restore_matching
from heterofusionrcnn_torch.runtime.optimizer import build_optimizer
from heterofusionrcnn_torch.runtime.train_state import TrainState

JAX_METRIC_KEYS = {
    "step", "rpn_seg_loss", "rpn_bin_cls_loss", "rpn_reg_loss", "total_loss", "seg_accuracy",
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


def _cli(root, *extra):
    return run_training.main(["--device", "cpu", "--pipeline_config", "rpn_unittest",
                              "--output_root", str(root), *extra])


def _metrics(root):
    with open(os.path.join(root, "rpn_unittest", "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_checkpoint_and_resume(tmp_path, capsys):
    """3 steps (checkpoints at 2 and 3, rpn_unittest's interval 2 and
    budget 3), then a second run that resumes at 3 and reaches 4; the
    module weights of a training checkpoint load into the test-mode RPN
    through `run_inference`'s reader."""
    state = _cli(tmp_path)
    base = tmp_path / "rpn_unittest"
    assert state.step == 3 and state.optimizer.count == 3
    assert (base / "rpn_unittest_config.json").is_file()
    ckpt = CheckpointManager(str(base / "checkpoints"))
    assert ckpt.all_steps() == [2, 3]
    lines = _metrics(tmp_path)
    assert [r["step"] for r in lines] == [1, 2, 3]
    for r in lines:
        assert set(r) == JAX_METRIC_KEYS
        assert all(v == v and abs(v) < float("inf") for v in r.values())
        assert r["device_mem_mb"] == 0.0

    resumed = _cli(tmp_path, "--max_iterations", "4")
    assert "Resumed from step 3" in capsys.readouterr().out
    assert resumed.step == 4 and resumed.optimizer.count == 4
    assert ckpt.all_steps() == [2, 3, 4]
    assert [r["step"] for r in _metrics(tmp_path)] == [1, 2, 3, 4]

    sd, step = run_inference.load_state(str(base / "checkpoints"))
    assert step == 4
    model = RpnModel(rpn_unittest().model_config, 3, CLUSTER_SIZES)
    model.load_state_dict(sd)
    for name, t in resumed.model.state_dict().items():
        assert torch.equal(t, sd[name]), name


def test_json_pipeline_config(tmp_path):
    """`--pipeline_config` as a JSON file named after its checkpoint_name
    (the nested layer configs rebuilt as dataclasses on load)."""
    cfg = rpn_unittest()
    cfg.train_config.checkpoint_interval = 1
    cfg.train_config.max_iterations = 2
    path = tmp_path / "rpn_unittest.json"
    save_config(cfg, str(path))
    state = run_training.main(["--device", "cpu", "--pipeline_config", str(path),
                               "--output_root", str(tmp_path / "out")])
    assert state.step == 2
    ckpt = CheckpointManager(str(tmp_path / "out" / "rpn_unittest" / "checkpoints"))
    assert ckpt.all_steps() == [1, 2]


def test_restore_round_trip(tmp_path):
    """A saved train state restores module, optimizer moments, EMA count
    and step into a fresh state."""
    state = _cli(tmp_path, "--max_iterations", "1")
    cfg = rpn_unittest()
    dataset = common.build_dataset(cfg, "train")
    model, _ = common.build_model(cfg, dataset, "train")
    fresh = TrainState.create(model, build_optimizer(model, cfg.train_config.optimizer))
    CheckpointManager(str(tmp_path / "rpn_unittest" / "checkpoints")).restore(fresh)
    assert fresh.step == 1 and fresh.optimizer.count == 1
    for a, b in zip(fresh.optimizer.state["nu"], state.optimizer.state["nu"]):
        assert torch.equal(a, b)
    for name, t in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[name], t), name


def test_host_rss_cap_checkpoints_and_exits_75(tmp_path, monkeypatch):
    monkeypatch.setenv("HFR_MAX_HOST_RSS_MB", "1")
    with pytest.raises(SystemExit) as exc:
        _cli(tmp_path)
    assert exc.value.code == 75
    assert CheckpointManager(str(tmp_path / "rpn_unittest" / "checkpoints")).all_steps() == [1]


def test_warm_start_takes_matching_tensors(tmp_path):
    """`--warm_start_from` copies same-named, same-shaped tensors; a
    tensor of another shape keeps the fresh value."""
    src = tmp_path / "src"
    model = RpnModel(rpn_unittest().model_config, 3, CLUSTER_SIZES)
    sd = {k: torch.full_like(v, 0.5) for k, v in model.state_dict().items()}
    sd["fc0.Dense_0.weight"] = torch.zeros(3, 3)
    CheckpointManager(str(src)).save(0, sd)
    state = _cli(tmp_path / "out", "--max_iterations", "1", "--warm_start_from", str(src))
    assert state.step == 1
    # One Adam step moves a parameter by about the learning rate (1e-3).
    assert float((state.model.seg_logits.Dense_0.bias.detach() - 0.5).abs().max()) < 0.01
    assert float((state.model.fc0.Dense_0.weight.detach() - 0.5).abs().min()) > 0.01
    target = {"a": torch.zeros(2), "b": torch.zeros(3)}
    out = restore_matching(target, {"a": torch.ones(2), "b": torch.ones(4), "c": torch.ones(1)})
    assert torch.equal(out["a"], torch.ones(2)) and torch.equal(out["b"], torch.zeros(3))
    assert set(out) == {"a", "b"}


@pytest.mark.parametrize("argv,exc", [
    # rpn_unittest's global batch of 2 does not split over 3 ranks.
    (["--num_devices", "3"], ValueError),
    # The RCNN trains now, but only from the RPN's handoff directories.
    (["--pipeline_config", "rcnn_unittest"], ValueError),
])
def test_unported_options_raise(tmp_path, argv, exc):
    base = ["--device", "cpu", "--pipeline_config", "rpn_unittest", "--output_root", str(tmp_path)]
    with pytest.raises(exc):
        run_training.main(base + argv)


def test_cuda_requested_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training.main(["--pipeline_config", "rpn_unittest", "--output_root", str(tmp_path)])
