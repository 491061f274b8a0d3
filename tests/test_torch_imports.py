"""The port stands alone: no file of `heterofusionrcnn_torch/`, not
`chip_smoke.py` and no workflow tool of the port (`tools/torch_*.py`)
imports jax, flax or the JAX package, nor OpenCV or PIL, which the card's
machine lacks (checked on the AST of every file, so an import inside a
function counts too). `tools/convert_orbax_checkpoint.py`, which reads JAX
checkpoints, is the one tool that imports both packages."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "heterofusionrcnn_tpu", "cv2", "PIL")
TOOLS = sorted((ROOT / "tools").glob("torch_*.py"))
FILES = (sorted((ROOT / "heterofusionrcnn_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + TOOLS)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_port_has_files():
    assert len(FILES) > 15
    assert len(TOOLS) == 5


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
