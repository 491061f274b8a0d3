"""Root test configuration: keep every test process off the persistent XLA
compile cache, and collect the two-stage pipeline's tests first.

`heterofusionrcnn_tpu/__init__.py` turns on JAX's persistent compilation
cache at `~/.cache/hfr_jax_cache` unless `HFR_NO_COMPILE_CACHE` is set. With
jax 0.9.0, loading the 8-device sharded CPU train step back from that cache
aborts the interpreter (`Fatal Python error: Aborted` in
`tests/test_rpn_model.py::test_rpn_data_parallel_8dev`), so the test passes
on a machine's first run and kills its worker on every later one. Tests
compile fresh instead: both switches are set here, before anything imports
jax (this file loads before `tests/conftest.py`).

`tests/test_two_stage_pipeline.py`'s tests all read one module-scoped
fixture that runs the JAX two-stage pipeline (minutes). Its file sorts near
the end, and pytest-xdist's `--dist load` hands out the last tests of a run
one or two at a time, so several workers each ran that fixture at once
(five in a tier-1 run, about 270 s each, the run's last minutes). Collected
first, its tests go to one worker in that worker's first chunk.

Every test runs on one torch intra-op thread (a test that wants another
count sets it itself): tier-1 runs six workers on a machine of a few cores,
and each worker's default of one thread a core kept the cores oversubscribed
(five of the port's test files took 132 s under six workers with the
default, 70 s with one thread).
"""

import os

import pytest

os.environ["HFR_NO_COMPILE_CACHE"] = "1"
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

FIRST_MODULES = ("tests/test_two_stage_pipeline.py",)


def pytest_collection_modifyitems(items):
    """The tests of FIRST_MODULES first, every other test in its order."""
    first = [item for item in items if item.nodeid.split("::")[0] in FIRST_MODULES]
    items[:] = first + [item for item in items if item.nodeid.split("::")[0] not in FIRST_MODULES]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for the test (module docstring)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
