"""Root test configuration: keep every test process off the persistent XLA
compile cache.

`heterofusionrcnn_tpu/__init__.py` turns on JAX's persistent compilation
cache at `~/.cache/hfr_jax_cache` unless `HFR_NO_COMPILE_CACHE` is set. With
jax 0.9.0, loading the 8-device sharded CPU train step back from that cache
aborts the interpreter (`Fatal Python error: Aborted` in
`tests/test_rpn_model.py::test_rpn_data_parallel_8dev`), so the test passes
on a machine's first run and kills its worker on every later one. Tests
compile fresh instead: both switches are set here, before anything imports
jax (this file loads before `tests/conftest.py`).
"""

import os

os.environ["HFR_NO_COMPILE_CACHE"] = "1"
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
