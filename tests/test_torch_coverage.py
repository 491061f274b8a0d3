"""Every top-level public function and class of `heterofusionrcnn_tpu/`
has a counterpart of the same name in the same module of
`heterofusionrcnn_torch/`, and every tool `tools/<name>.py` that imports
the JAX package has a port counterpart `tools/torch_<name>.py` (all read as
ASTs, nothing imported), but for the exemptions below, each with its
counterpart in the port or the reason it has none."""

from __future__ import annotations

import ast
import fnmatch
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
    # The device mesh of JAX's data parallelism: the port's
    # `parallel/mesh.py` works with a torch.distributed process group
    # (`rank_and_size`, `replicate_state`, `all_reduce_flat`).
    ("parallel/mesh.py", "make_data_mesh"),
    # The shardings JAX's batch-sharded serving jits the fused function with
    # (tests/test_parallel_extras.py): the port places the weights with
    # `parallel/mesh.py:replicate_module`, reads the outputs back with
    # `gather_rows`, and runs the forward with `inference.sharded_forward`.
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


# Tools that import the JAX package and have no `tools/torch_<name>.py`:
# the TPU measurement tools (the port's are `chip_smoke.py` and its card
# tools, `tools/{knn_sweep,cluster_sweep,xconv_ablation,...}.py`), and the
# converter, which reads JAX checkpoints by design and is a port tool.
EXEMPT_TOOLS = {"check_kernels.py", "flops_ledger.py", "microbench_*.py", "profile_stages.py",
                "sweep_knn_tiles.py", "convert_orbax_checkpoint.py"}


def _imports_jax_package(path: Path) -> bool:
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
        if any(n.split(".")[0] == JAX_PKG.name for n in names):
            return True
    return False


JAX_TOOLS = sorted(p.name for p in (ROOT / "tools").glob("*.py")
                   if not p.name.startswith("torch_") and _imports_jax_package(p))


def _tool_exempt(name: str) -> bool:
    return any(fnmatch.fnmatch(name, pattern) for pattern in EXEMPT_TOOLS)


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


def test_every_jax_tool_has_a_port_counterpart():
    missing = [n for n in JAX_TOOLS
               if not _tool_exempt(n) and not (ROOT / "tools" / f"torch_{n}").is_file()]
    assert not missing, f"no tools/torch_<name>.py for: {missing}"


@pytest.mark.parametrize("pattern", sorted(EXEMPT_TOOLS))
def test_tool_exemption_is_needed(pattern):
    """A tool exemption names at least one tool that imports the JAX
    package and has no port counterpart."""
    assert [n for n in JAX_TOOLS if fnmatch.fnmatch(n, pattern)
            and not (ROOT / "tools" / f"torch_{n}").is_file()]
