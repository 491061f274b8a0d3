"""Every top-level public function and class of `heterofusionrcnn_tpu/`
has a counterpart of the same name in the same module of
`heterofusionrcnn_torch/` (both read as ASTs, nothing imported), but for
the exemptions below, each with its counterpart in the port or the reason
it has none."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "heterofusionrcnn_tpu", ROOT / "heterofusionrcnn_torch"

# Whole modules: the Pallas kernels and their tile planners. Each kernel is
# a CUDA kernel of `ops/csrc/` behind the op of the JAX dispatch's module
# (`conv3x3_affine_relu` and `convtranspose3x3_affine_relu` in `ops/conv.py`,
# `crop_gather` in `ops/cropping.py`, `farthest_point_sample` in
# `ops/sampling.py`, `knn_point` in `ops/grouping.py`, `oriented_nms` in
# `ops/nms.py`, `fused_xconv` in `ops/xconv.py`); the planners are the
# kernels' own (`ops/xconv.py:plan_xconv`, `ops/sampling.py:fps_plan`,
# `ops/nms.py:nms_plan`, `ops/grouping.py:knn_arm`).
EXEMPT_MODULES = {
    "ops/pallas_conv.py", "ops/pallas_convtranspose.py", "ops/pallas_crop.py",
    "ops/pallas_fps.py", "ops/pallas_knn.py", "ops/pallas_nms.py", "ops/pallas_xconv.py",
}
EXEMPT = {
    # The device mesh and shardings of JAX's data parallelism: the port's
    # `parallel/mesh.py` works with a torch.distributed process group
    # (`rank_and_size`, `replicate_state`, `all_reduce_flat`).
    ("parallel/mesh.py", "make_data_mesh"),
    ("parallel/mesh.py", "batch_sharding"),
    ("parallel/mesh.py", "replicated"),
    # Whether the Pallas kernels may run: the port dispatches by the
    # tensor's device (`ops/dispatch.py`), with no switch.
    ("ops/dispatch.py", "pallas_ok"),
    # optax's EMA transform and its state: `Optimizer.ema` and
    # `Optimizer.ema_state_dict` (`runtime/optimizer.py`).
    ("runtime/optimizer.py", "ParamEmaState"),
    ("runtime/optimizer.py", "param_ema"),
    ("runtime/optimizer.py", "get_ema_params"),
    # The jitted fused two-stage function: `inference.build_two_stage` /
    # `inference.TwoStageDetector`.
    ("experiments/run_inference.py", "build_fused_inference"),
}


def _public_names(pkg: Path):
    """{(module path, name)} of the top-level public functions and classes."""
    out = set()
    for path in pkg.rglob("*.py"):
        for node in ast.parse(path.read_text(), filename=str(path)).body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                    and not node.name.startswith("_")):
                out.add((str(path.relative_to(pkg)), node.name))
    return out


JAX_NAMES = _public_names(JAX_PKG)
PORT_NAMES = _public_names(PORT_PKG)


def test_every_jax_function_and_class_has_a_port_counterpart():
    missing = sorted(n for n in JAX_NAMES - PORT_NAMES
                     if n[0] not in EXEMPT_MODULES and n not in EXEMPT)
    assert not missing, f"no counterpart in heterofusionrcnn_torch/: {missing}"


@pytest.mark.parametrize("entry", sorted(EXEMPT), ids=lambda e: f"{e[0]}:{e[1]}")
def test_exemption_is_needed(entry):
    """An exemption names a JAX function or class that exists and that the
    port does not have."""
    assert entry in JAX_NAMES and entry not in PORT_NAMES


@pytest.mark.parametrize("module", sorted(EXEMPT_MODULES))
def test_exempt_module_exists(module):
    assert (JAX_PKG / module).is_file()
