"""Every cell, configuration, traffic mix and metric of BENCHMARK.json has
its files, found by name, and the file keeps the contract's limits."""

import json
import pathlib
import re

import pytest

from benchmark.harness import spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_and_names_a_known_config(cell):
    c = spec.load_cell(cell)
    names = {x["name"] for x in BENCH["configs"]}
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert w["config"] in names and c.config["name"] == w["config"]
    assert c.traffic["residency"] in ("device", "host")
    assert c.chips in (1, 4) and len(w["why"]) <= 200
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["source"] == cfg["source"] and len(cfg["source"]) <= 200
    assert data["reduced"] == cfg["reduced"]
    assert set(data["check"]["limits"]) == {"bad", "bound", "decode_gap", "coef_gap"}
    assert data["check"]["limits"]["bound"] == 1.0  # the configuration's own
    assert data["check"]["limits"]["bad"] == 0  # exact


def test_names_units_and_metric_readers():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert callable(spec.reader(m["name"]))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
