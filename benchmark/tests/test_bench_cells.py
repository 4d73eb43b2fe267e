"""BENCHMARK.json against the contract, and discovery of cells,
configurations, traffic mixes, limits and metric readers by name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import check, harness

ROOT = Path(harness.ROOT)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1].startswith("benchmark/")
    assert 1 <= BENCH["run_seconds"] <= 51


def test_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for item in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(item["name"]), item["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len({m["name"] for m in metrics}) == len(metrics)


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = harness.load_cell(name)
    assert cell.workload["chips"] == 1
    assert cell.traffic["name"] == cell.workload["traffic"]
    assert cell.config["name"] == cell.workload["config"]
    assert cell.limits["limits"] and set(cell.limits["limits"]) <= set(check.NUMBERS)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "frames_per_s"}
    assert cell.per_layer


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_matches_entry(config):
    path = ROOT / config["file"]
    assert path.parts[len(ROOT.parts)] == "benchmark"
    data = json.loads(path.read_text())
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    assert data["body"]["num_verts"] == 6890 and data["body"]["num_faces"] == 13776


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.metric_reader(metric))


def test_unknown_names_raise():
    with pytest.raises(harness.RunError):
        harness.load_cell("no.such.cell")
    with pytest.raises(harness.RunError):
        harness.metric_reader("no_such_metric")

