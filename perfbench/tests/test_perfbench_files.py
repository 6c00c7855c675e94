"""BENCHMARK.json against the contract's shapes, every file found by name,
and the imports of the benchmark's modules."""
import ast
import json
import re
from pathlib import Path

import pytest

from perfbench_helpers import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PERFBENCH = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_found_by_name(cell):
    from perfbench import harness

    spec, config = harness.load_cell(cell["name"])
    assert spec["config"] == cell["config"] and spec["traffic"] == cell["traffic"]
    assert config["name"] == cell["config"]
    assert cell["chips"] == 1
    assert spec["limits"], "a cell without limits cannot be correct"
    e2e = harness.cell_metrics(cell["name"], False, BENCH)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert harness.cell_metrics(cell["name"], True, BENCH)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_found_by_name(config):
    path = ROOT / config["file"]
    assert path.parent == PERFBENCH / "configs"
    spec = json.loads(path.read_text())
    assert spec["name"] == config["name"] and spec["source"] == config["source"]
    assert spec["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_readers_found_by_name(metric):
    from perfbench import harness

    assert callable(harness.reader(metric["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if metric in BENCH["per_layer"]:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25


def imported_top_levels(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(PERFBENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_jax_anywhere_and_no_program_in_the_reference(path):
    names = imported_top_levels(path)
    assert not names & {"jax", "jaxlib", "flax", "sbayes_tpu"}
    if "reference" in path.relative_to(PERFBENCH).parts:
        assert "sbayes_tpu_torch" not in names
