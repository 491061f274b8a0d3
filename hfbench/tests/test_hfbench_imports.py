"""What the benchmark imports: no module that `hfbench/run.py` or the
reference loads has a top-level name (the part before the first dot,
compared whole) among JAX, its libraries, the JAX package or the
repository's JAX-era scripts, and the reference loads nothing of the
program. Each check imports in a fresh interpreter, so nothing the test
process loaded counts."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

import hfbench_cells
from hfbench import harness

PROGRAM = harness.PROGRAM
SNIPPET = """
import json, sys
sys.path.insert(0, {repo!r})
for m in {mods!r}:
    __import__(m)
print(json.dumps(sorted({{n.split('.', 1)[0] for n in sys.modules}})))
"""


def loaded(mods):
    code = SNIPPET.format(repo=hfbench_cells.REPO, mods=list(mods))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300, env=env, cwd=hfbench_cells.REPO)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def modules_under(sub: str):
    root = os.path.join(harness.HERE, sub)
    return ["hfbench." + sub + "." + f[:-3] for f in sorted(os.listdir(root))
            if f.endswith(".py") and f != "__init__.py"]


def test_run_and_entries_load_nothing_forbidden():
    mods = ["hfbench.run", "hfbench.readings", "hfbench.harness", "hfbench.judge",
            "hfbench.trace", "hfbench.weights", "hfbench.flops", "hfbench.inputs.traffic",
            "heterofusionrcnn_torch.inference", "heterofusionrcnn_torch.runtime.train_state",
            *modules_under("entries"), *modules_under("reference")]
    tops = loaded(mods)
    assert not tops & set(harness.FORBIDDEN_MODULES), tops & set(harness.FORBIDDEN_MODULES)


def test_reference_loads_nothing_of_the_program():
    tops = loaded(modules_under("reference") + ["hfbench.inputs.kitti"])
    assert PROGRAM not in tops and not tops & set(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted(
    os.path.join(d, f) for d, _, fs in os.walk(os.path.join(hfbench_cells.REPO, "hfbench", "reference"))
    for f in fs if f.endswith(".py")))
def test_reference_sources_import_no_program(path):
    """The reference's sources name no module of the program or of JAX."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for n in names:
            top = n.split(".", 1)[0]
            assert top != PROGRAM and top not in harness.FORBIDDEN_MODULES, (path, n)


def test_forbidden_loaded_compares_whole_names(monkeypatch):
    """The port's name begins with the JAX package's: only whole top-level
    names count."""
    before = set(harness.forbidden_loaded())
    monkeypatch.setitem(sys.modules, "heterofusionrcnn_tpux", object())
    monkeypatch.setitem(sys.modules, "toolsy.x", object())
    assert set(harness.forbidden_loaded()) == before
    monkeypatch.setitem(sys.modules, "tools.foo", object())
    assert "tools" in harness.forbidden_loaded()
