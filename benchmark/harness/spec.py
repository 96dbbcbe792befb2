"""What a cell is, read from files found by name.

BENCHMARK.json (at the checkout's root) names the cell's configuration, its
traffic mix and its metrics; benchmark/configs/<config>.json holds the
deployment (shape, fields and their recipes, codec configuration, the
container it must produce, the limits of the correctness check);
benchmark/traffic/<traffic>.json holds the traffic parameters (where the
fields live, their order); benchmark/metrics/<metric>.py reads one metric
from a run's records. Adding a configuration, a traffic mix, a cell or a
metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_json: pathlib.Path | None = None) -> Cell:
    spec = _load_json(bench_json or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load_json(ROOT / configs[w["config"]]["file"])
    traffic = _load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def reader(metric: str):
    """The read(run) function of benchmark/metrics/<metric>.py."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    mod_name = "benchmark_metric_" + metric.replace(".", "_").replace("-", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read
