"""The control: the program with TF32 switched on for its matmuls and
convolutions (the precision below the configurations' float32 with TF32
off; `inference.exact_float32` is the switch) must come out not correct in
every cell, at the cell's own size, on three seeds. TF32 exists only on
the card, so these run there:

    python -m pytest --noconftest -m cuda hfbench/tests/test_hfbench_control.py
"""

from __future__ import annotations

import pytest
import torch

import hfbench_cells  # noqa: F401
from hfbench import harness
from hfbench.readings import readings

SEEDS = (7100000001, 7100000002, 7100000003)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark()["workloads"]])
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA card")
    for seed, res in readings(cell, SEEDS, control=True, seconds=2.0):
        assert not res["correct"], (seed, res["checks"])
