"""The per-layer metrics read from the program's spans inside the DTZS
pipeline and the host entropy stage, and from its counters: a CPU
rehearsal of each one-chip cell with --trace 1 reports every such metric in
the cells its entry lists, and none elsewhere; its calls carry the
program's counts, which an untraced run's do not."""

import functools
import json
import pathlib
import subprocess
import sys

import pytest

from benchmark.harness import readers, window

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = ["pack_wait_ms.compress", "device_wait_ms.compress",
                "prep_wait_ms.decompress", "copy_out_ms.decompress",
                "entropy_cpu_ms.compress", "entropy_cpu_ms.decompress"]
ONE_CHIP = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]


COUNT_METRICS = [m["name"] for m in BENCH["per_layer"]
                 if m["source"] == "program_counter"]


@functools.lru_cache(maxsize=None)
def _traced(cell: str) -> dict:
    """The result line of one traced CPU rehearsal of the cell."""
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 7), "--seconds", "1", "--trace", "1", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_traced_rehearsal_reports_the_span_metrics(cell):
    out = _traced(cell)
    assert out["correct"] is True and out["failed"] == 0
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert m["source"] == "program_span"
        key = "cpu_rehearsal." + name
        if cell in m["workloads"]:
            assert key in out["metrics"], (name, sorted(out["metrics"]))
            assert out["metrics"][key]["value"] >= 0.0
            assert out["metrics"][key]["unit"] == "ms"
        else:
            assert key not in out["metrics"]


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_traced_rehearsal_reports_the_counter_metrics(cell):
    out = _traced(cell)
    assert "syncs.compress" in COUNT_METRICS and "syncs.decompress" in COUNT_METRICS
    for name in COUNT_METRICS:
        m = next(m for m in BENCH["per_layer"] if m["name"] == name)
        key = "cpu_rehearsal." + name
        if cell in m["workloads"]:
            assert out["metrics"][key]["value"] > 0.0, name
        else:
            assert key not in out["metrics"]


def test_count_per_call():
    def call(kind, counts):
        return window.Call(kind, 0, 1.0, 4, 1, {}, counts)

    run = window.Run(1.0, [call("compress", {"syncs": 3, "frames": 8}),
                           call("compress", {"syncs": 5}),
                           call("decompress", {"frames": 8})])
    assert readers.count_per_call(run, "compress", "syncs") == 4.0
    assert readers.count_per_call(run, "compress", "frames") == 4.0
    assert readers.count_per_call(run, "decompress", "syncs") is None
    untraced = window.Run(1.0, [window.Call("compress", 0, 1.0, 4, 1)])
    assert readers.count_per_call(untraced, "compress", "syncs") is None
