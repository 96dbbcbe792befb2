"""A later change adds a traffic mix, a cell and a per-layer metric as new
files and entries: run in a copy, the new cell runs and reports the new
metric, and no existing file under benchmark/ was edited."""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _digests(d: pathlib.Path) -> dict:
    return {str(p.relative_to(d)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_throwaway_cell_and_metric_as_new_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "dctz_tpu_torch", tmp_path / "dctz_tpu_torch")
    os.symlink(ROOT / "cpp", tmp_path / "cpp")
    before = _digests(tmp_path / "benchmark")
    (tmp_path / "benchmark" / "traffic" / "reversed.json").write_text(json.dumps(
        {"residency": "host", "order": ["PHIS", "FLDSC", "FREQSH", "CLDLOW", "CLDHGH"]}))
    (tmp_path / "benchmark" / "metrics" / "calls_total.py").write_text(
        '"""Round trips in the window."""\n\n\n'
        "def read(run):\n    return len(run.of(\"compress\"))\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "cesm-qt.reversed", "config": "cesm-atm-qt",
                              "traffic": "reversed", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "calls_total", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "API transfer", "moves": "compress_gbps",
                              "workloads": ["cesm-qt.reversed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cesm-qt.reversed", "--seed", "3", "--seconds", "1",
                        "--trace", "1", "--device", "cpu"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["cpu_rehearsal.calls_total"]["value"] >= 1
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
