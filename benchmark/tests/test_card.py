"""On the card: one short run of each one-chip cell is correct and reports
its end-to-end metrics, all of them and no others, on the card's name."""

import json
import pathlib
import subprocess
import sys

import pytest

from benchmark.harness import spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]
                                  if w["chips"] == 1])
def test_cell_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                        "--seed", "77", "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {m["name"] for m in spec.load_cell(cell).end_to_end}
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
