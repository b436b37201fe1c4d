"""BENCHMARK.json against the benchmark's contract, and the configuration
files it names."""
from __future__ import annotations

import json
import re

import pytest
from tb_small import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_names(bench):
    assert set(bench) == KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
        for e in bench[group]:
            extra = set(e) - KEYS[group]
            assert extra <= ({"workloads"} if group in (
                "end_to_end", "per_layer") else set()), (group, extra)
            assert KEYS[group] <= set(e)
            assert NAME.match(e["name"]), e["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert line_ok(w["why"]) and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert all(line_ok(w) for w in bench["command"])
    assert len(bench["command"]) <= 32


def test_cells_metrics_and_bounds(bench):
    assert [w["name"] for w in bench["workloads"]] == list(CELLS)
    assert all(w["chips"] == 1 for w in bench["workloads"])
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(bench["per_layer"]) == 6
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(m["layer"])
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", [cell])
        assert (ROOT / "tallybench" / "metrics" / f"{m['name']}.py").exists()
    for m in bench["end_to_end"]:
        assert (ROOT / "tallybench" / "metrics" / f"{m['name']}.py").exists()
    for w in bench["workloads"]:
        reports = [m for m in bench["end_to_end"]
                   if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reports) >= 2
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] == "segments_per_s"


def test_budget_fits_24_cells(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("name", ["pincell-casmo8-f64", "assembly17-casmo70-f64"])
def test_configuration_loads(bench, name):
    entry = {c["name"]: c for c in bench["configs"]}[name]
    assert entry["file"].startswith("tallybench/configs/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == name and cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]
    assert cfg["dtype"] in ("float32", "float64")
    assert cfg["particles"] == 1048576
    for key in ("mesh", "n_groups", "materials", "tolerance", "assumed",
                "reference_dtype", "survival_weight", "max_events"):
        assert key in cfg


def test_paths_and_command(bench):
    assert bench["paths"] == ["tallybench"]
    assert bench["command"] == ["python3", "tallybench/run.py"]
    for w in bench["workloads"]:
        assert (ROOT / "tallybench" / "traffic"
                / f"{w['traffic']}.json").exists()
        assert (ROOT / "tallybench" / "limits"
                / f"{w['name']}.json").exists()
