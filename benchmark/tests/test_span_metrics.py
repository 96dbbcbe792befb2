"""The per-layer metrics read from the program's spans inside the DTZS
pipeline and the host entropy stage: a CPU rehearsal of each one-chip cell
with --trace 1 reports every such metric in the cells its entry lists, and
none elsewhere."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = ["pack_wait_ms.compress", "device_wait_ms.compress",
                "prep_wait_ms.decompress", "copy_out_ms.decompress",
                "entropy_cpu_ms.compress", "entropy_cpu_ms.decompress"]
ONE_CHIP = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_traced_rehearsal_reports_the_span_metrics(cell):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 7), "--seconds", "1", "--trace", "1", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
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
