"""BENCHMARK.json and every file it names: each configuration, cell,
traffic and metric file loads and agrees with BENCHMARK.json, names and
units use only the allowed characters, and each configuration's recipe
builds its frozen configuration in the program."""

from __future__ import annotations

import json
import os
import re

import pytest

import hfbench_cells  # noqa: F401  (puts the repository on sys.path)
from hfbench import flops, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = harness.benchmark()


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "hfbench/run.py"]
    assert BENCH["paths"] == ["hfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


LISTED = {c["file"]: c for c in BENCH["configs"]}
CONFIG_FILES = sorted("hfbench/configs/" + f for f in os.listdir(os.path.join(harness.HERE, "configs")))


@pytest.mark.parametrize("path", CONFIG_FILES)
def test_config_file(path):
    """Every configuration file, listed in BENCHMARK.json or kept for a
    cell to come, builds its frozen configuration."""
    data = harness.load_json(os.path.join(harness.REPO, path))
    assert data["reduced"] == []
    cfg = LISTED.get(path)
    if cfg is not None:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(cfg["name"]) and PATH.match(cfg["file"])
        assert one_line(cfg["source"]) and one_line(cfg["why"])
        assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
        assert data["reduced"] == cfg["reduced"]
    assert data["peak_flops_per_s"] == flops.PEAK_FLOPS_PER_S[data["compute_dtype"]]
    programs = harness.program_configs(data)
    references = harness.reference_configs(data)
    for stage in programs:
        assert harness._plain(references[stage]) == data["pipeline"][stage]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] == 1
    assert one_line(cell["why"])
    c = harness.find_cell(cell["name"])
    assert c.spec["why"] == cell["why"]
    assert os.path.exists(os.path.join(harness.HERE, "entries", c.kind + ".py"))
    limits = c.spec["check"]["limits"]
    assert limits and all(v > 0 for v in limits.values())
    for key in ("batch", "repeats", "flipped_share", "labels", "trace_start", "trace_iterations"):
        assert key in c.traffic
    e2e = harness.cell_metrics(c, False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert harness.cell_metrics(c, True)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    mod = harness.reader(metric["name"])
    assert mod.SOURCE == metric["source"] and callable(mod.read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert one_line(metric["layer"])
        assert not hasattr(mod, "LAYER") and not hasattr(mod, "MOVES")
        moved = [m for m in BENCH["end_to_end"] if m["name"] == metric["moves"]]
        assert moved
        assert set(metric["workloads"]) <= set(moved[0].get("workloads", cells))


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_check_budget():
    """A full check of 24 cells fits 43200 s."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
