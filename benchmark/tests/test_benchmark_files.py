"""The benchmark's files: ``BENCHMARK.json`` against the shapes it must have,
every cell's configuration and traffic found by name, every per-layer
metric a file that loads."""
from __future__ import annotations

import json
import re

import pytest

from benchmark import harness
from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entries(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
    assert all(NAME.match(k) and not k.endswith(("_dim", "_rank")) for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])
    assert 1 <= len(cfg["why"]) <= 200 and 1 <= len(cfg["source"]) <= 200


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cells_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}" and cell["chips"] in (1, 4)
    found = harness.load_cell(cell["name"])
    assert found["workload"]["config"] == cell["config"]
    assert found["workload"]["traffic"] == cell["traffic"]
    assert set(found["workload"]["limits"]) <= set(harness.READINGS)
    assert found["traffic"]["entry"] in ("solve", "lanes")
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]


def test_every_workload_file_names_existing_files():
    names = [p.stem for p in (ROOT / "benchmark" / "workloads").glob("*.json")]
    assert sorted(names) == sorted(w["name"] for w in SPEC["workloads"])
    for n in names:
        cell = harness.load_cell(n)
        assert cell["config"]["config"] and cell["traffic"]["patch"]


def test_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert {"patch_iters_per_s", "peak_mem_gib", "setup_s"} == e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    readers = harness.load_metrics()
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["name"] in readers and readers[m["name"]].UNIT == m["unit"]
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert set(readers) == {m["name"] for m in SPEC["per_layer"]}


def test_a_cell_is_a_workload_file(tmp_path):
    """A later cell is a workload file beside the others: the harness finds
    it, its configuration and its traffic by name."""
    (tmp_path / "mrunet3d.solo256x.json").write_text(json.dumps(
        {"config": "mrunet3d", "traffic": "solo256", "chips": 1,
         "limits": {"loss0_gap": 1.0}}))
    cell = harness.load_cell("mrunet3d.solo256x", tmp_path)
    assert cell["config"]["config"]["datadim"] == "3d"
    assert cell["traffic"]["patch"] == [256, 128, 128]
