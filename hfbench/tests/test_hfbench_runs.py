"""Whole runs of each cell on the CPU at the port's unittest widths (the
harness's look for a card skipped): sound runs come out correct, with the
reference agreeing with the port's CPU path, and a run with the timed path
broken underneath (`hfbench/faults.py`) comes out not correct, once for
each fault the cell can have. On the CPU the port runs its plain kernels, so these hold the
harness, the reference and the comparison; the control, which needs the
card's TF32, is `test_hfbench_control.py`."""

from __future__ import annotations

import pytest

from hfbench_cells import run_small, small_cell
from hfbench.faults import FAULTS


def _assert_correct(res):
    assert res["correct"], res["checks"]
    for name, (value, limit) in res["checks"].items():
        assert value <= limit / 10, (name, value, limit)


@pytest.mark.parametrize("cell", ["pcnn_f32.offline_b16", "pnet_rpn_f32.serve",
                                  "pcnn_f32.train_rpn_b8"])
def test_sound_run_is_correct(cell):
    """The reference agrees with the port's CPU path well inside every limit."""
    _assert_correct(run_small(cell))


@pytest.mark.parametrize("fault", sorted(FAULTS["serve"]))
@pytest.mark.parametrize("cell", ["pcnn_f32.offline_b16", "pnet_rpn_f32.serve"])
def test_serving_fault_is_caught(monkeypatch, cell, fault):
    FAULTS["serve"][fault](monkeypatch, small_cell(cell).spec["model"])
    assert not run_small(cell)["correct"]


@pytest.mark.parametrize("fault", sorted(FAULTS["train"]))
def test_training_fault_is_caught(monkeypatch, fault):
    FAULTS["train"][fault](monkeypatch, None)
    assert not run_small("pcnn_f32.train_rpn_b8")["correct"]
