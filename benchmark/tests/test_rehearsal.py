"""The explicit CPU rehearsal of each one-chip cell at its tiny size runs
the whole of a run and prints the contract's result line, naming no device
metric; without a card, or without the program, a run prints no result."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
ONE_CHIP = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
DEVICE_NAMES = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}


def _run(cwd, *args, timeout=600):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_cpu_rehearsal_prints_the_result_line(cell, trace):
    p = _run(ROOT, "--workload", cell, "--seed", str(2**31 + 99),
             "--seconds", "1", "--trace", trace, "--device", "cpu")
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device",
                         "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert out["device"]["platform"] == "cpu"
    assert out["metrics"] and not set(out["metrics"]) & DEVICE_NAMES
    assert all(k.startswith("cpu_rehearsal.") for k in out["metrics"])
    assert set(out["checks"]) == {"bad", "bound", "decode_gap", "coef_gap"}
    # the checks are also the last lines of stderr
    tail = p.stderr.strip().splitlines()[-4:]
    assert [t.split()[0] for t in tail] == list(out["checks"])


def test_no_card_no_result():
    p = _run(ROOT, "--workload", ONE_CHIP[0], "--seed", "1", "--seconds", "1",
             "--trace", "0")
    try:
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present")
    except ImportError:
        pass
    assert p.returncode != 0 and not p.stdout.strip()


def test_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for dev in ("cpu", "cuda"):
        p = _run(tmp_path, "--workload", ONE_CHIP[0], "--seed", "1",
                 "--seconds", "1", "--trace", "0", "--device", dev)
        assert p.returncode != 0 and not p.stdout.strip()
