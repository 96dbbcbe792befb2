"""The runner of cells of several ranks (harness/ranks.py), on the
four-rank NYX cell. BENCHMARK.json does not hold that cell yet (its
decompress rate spread past half of the rates' bound, PERF.md §7), so each
run here is made in a copy of the benchmark whose BENCHMARK.json adds the
cell's entries below. Its CPU rehearsal over four gloo processes prints the
contract's result line, correct, on four devices; the same run with the
timed path broken underneath, in one rank or in all, comes out `correct`
false for each fault the cell can have; the rank skew's readers on made-up
calls; the ranks' CPU shares; on four cards, one short run of the cell."""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark.harness import ranks, spec, window

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
DEVICE_NAMES = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
CELL = "nyx-ec.4rank"
CONFIG = json.loads(
    (ROOT / "benchmark" / "configs" / "nyx-512-ec-4rank.json").read_text())
# the cell's entries, as a later change adds them to BENCHMARK.json
ENTRIES = {
    "configs": [{"name": CONFIG["name"], "source": CONFIG["source"],
                 "file": "benchmark/configs/nyx-512-ec-4rank.json",
                 "reduced": CONFIG["reduced"],
                 "why": "NYX EC at 1E-3 with verify over four NCCL ranks: a "
                        "512x512x128 slab a rank, one 32Mi DPK frame each, "
                        "scalars all-reduced"}],
    "workloads": [{"name": CELL, "config": CONFIG["name"], "traffic": "posthoc",
                   "chips": 4,
                   "why": "four ranks each hold a 128 MiB slab of six NYX fields "
                          "on the host; closed loop, one collective compress "
                          "then restore a field: parallel/ and NCCL"}],
    # the rates it reports end to end: compress_gbps, which BENCHMARK.json
    # no longer holds, comes back as a new entry; decompress_gbps gains it
    "end_to_end": [{"name": "compress_gbps", "unit": "GB/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock", "workloads": [CELL]}],
    "per_layer": [{"name": f"rank_skew_ms.{k}", "unit": "ms", "better": "lower",
                   "source": "host_clock", "layer": "ranks",
                   "moves": f"{k}_gbps", "workloads": [CELL]}
                  for k in ("compress", "decompress")],
    # the per-layer metrics of the device the cell reads too
    "device_metrics": ["device_idle.compress", "device_idle.decompress",
                       "decode_roofline"],
}


def with_cell(bench: dict) -> dict:
    """BENCHMARK.json with the four-rank cell's entries added."""
    out = json.loads(json.dumps(bench))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        out[key] += ENTRIES[key]
    for m in out["end_to_end"]:
        if m["name"] == "decompress_gbps":
            m["workloads"].append(CELL)
    for m in out["per_layer"]:
        if m["name"] in ENTRIES["device_metrics"]:
            m["workloads"].append(CELL)
    return out


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark, the program linked in, whose BENCHMARK.json
    holds the four-rank cell."""
    d = tmp_path_factory.mktemp("ranks")
    shutil.copytree(ROOT / "benchmark", d / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("dctz_tpu_torch", "cpp"):
        os.symlink(ROOT / name, d / name)
    (d / "BENCHMARK.json").write_text(json.dumps(with_cell(BENCH)))
    return d


def _run(checkout, *args, env=None, device="cpu", timeout=600):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         str(2**32 + 11), *args, "--device", device],
        cwd=checkout, capture_output=True, text=True, timeout=timeout, env=env)


def _line(p) -> dict:
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_cell_entries_keep_the_contract(checkout):
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    cell = spec.load_cell(CELL, checkout / "BENCHMARK.json")
    assert cell.chips == CONFIG["chips"] == 4 and CONFIG["reduced"] == []
    assert cell.traffic["residency"] == "host"
    assert {m["name"] for m in cell.end_to_end} == {
        "compress_gbps", "decompress_gbps", "ratio", "setup_s"}
    ends = {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert m["moves"] in ends
    assert len(ENTRIES["workloads"][0]["why"]) <= 200
    assert len(ENTRIES["configs"][0]["why"]) <= 200
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)
    for m in ENTRIES["per_layer"]:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("trace", ["0", "1"])
def test_rank_rehearsal_prints_the_result_line(checkout, trace):
    out = _line(_run(checkout, "--seconds", "1", "--trace", trace))
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device",
                         "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["count"] == 4
    assert out["metrics"] and not set(out["metrics"]) & DEVICE_NAMES
    names = {k.removeprefix("cpu_rehearsal.") for k in out["metrics"]}
    if trace == "0":
        assert names == {"compress_gbps", "decompress_gbps", "ratio", "setup_s"}
    else:  # the trace's readers find no card; the ranks' skew is the host's
        assert names == {"rank_skew_ms.compress", "rank_skew_ms.decompress"}
        assert all(v["value"] >= 0.0 for v in out["metrics"].values())


def test_rank_cell_without_cards_prints_no_result(checkout):
    import torch

    if torch.cuda.device_count() >= 4:
        pytest.skip("four cards are present")
    p = _run(checkout, "--seconds", "1", "--trace", "0", device="cuda",
             timeout=120)
    assert p.returncode != 0 and not p.stdout.strip()


# Each fault is planted by a sitecustomize module in every process of the
# run (run.py's rank 0 and the ranks it starts); RANK tells the ranks it
# starts apart (rank 0 sets its own later).
FAULTS = {
    # an answer altered where it is produced: one rank's restored slab
    "restored_slab": """
        if os.environ.get("RANK") == "2":
            from dctz_tpu_torch.parallel import multihost as mh
            real = mh.decompress_multihost
            def decompress_multihost(*a, **kw):
                r = real(*a, **kw)
                d = r.data.copy()
                d[d.size // 3] += 0.01 * float(d.max() - d.min())
                return mh.LocalRestore(d, r.start, r.frames)
            mh.decompress_multihost = decompress_multihost
    """,
    # a stored coefficient altered inside one rank's encode
    "stored_coefficient": """
        if os.environ.get("RANK") == "1":
            from dctz_tpu_torch.ops import dpk_fuse
            real = dpk_fuse.encode_x_fused
            def encode_x_fused(*a, **kw):
                outs = list(real(*a, **kw))
                dc = outs[6].clone()
                dc[dc.shape[0] // 2] += 1.0
                outs[6] = dc
                return tuple(outs)
            dpk_fuse.encode_x_fused = encode_x_fused
    """,
    # half of every rank's slab left out of the compress
    "half_left_out": """
        from dctz_tpu_torch.parallel import multihost as mh
        real = mh.compress_multihost
        def compress_multihost(local, *a, **kw):
            return real(local[: local.shape[0] // 2], *a, **kw)
        mh.compress_multihost = compress_multihost
    """,
    # the exchange between ranks left out: each rank keeps its own scalars
    "exchange_left_out": """
        from dctz_tpu_torch.parallel import sharding
        sharding.all_reduce = lambda t, op: t
    """,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_rank_run_incorrect(checkout, tmp_path, fault):
    (tmp_path / "sitecustomize.py").write_text(
        "import os\n" + textwrap.dedent(FAULTS[fault]))
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}:{checkout}")
    out = _line(_run(checkout, "--seconds", "0.5", "--trace", "0", env=env))
    assert out["correct"] is False, out["checks"]


def _calls(kind, rank_seconds):
    return [ranks.RankCall(kind, 0, max(rs), 4, 1, None, tuple(rs))
            for rs in rank_seconds]


def test_rank_skew_readers():
    run = window.Run(1.0, _calls("compress", [(1.0, 1.2, 1.0, 1.0),
                                              (2.0, 2.0, 2.0, 2.4)])
                     + _calls("decompress", [(0.5, 0.5, 0.5, 0.5)]))
    # (1.2 - 1.05) and (2.4 - 2.1), averaged: 225 ms
    assert spec.reader("rank_skew_ms.compress")(run) == pytest.approx(225.0)
    assert spec.reader("rank_skew_ms.decompress")(run) == pytest.approx(0.0)
    # a run of one card's calls holds nothing to read
    one = window.Run(1.0, [window.Call("compress", 0, 1.0, 4, 1)])
    assert spec.reader("rank_skew_ms.compress")(one) is None
    assert spec.reader("rank_skew_ms.decompress")(window.Run(1.0, [])) is None


@pytest.mark.parametrize("n_cpus,world", [(32, 4), (8, 4), (9, 4), (3, 4), (8, 1)])
def test_cpu_shares_are_equal_and_disjoint(n_cpus, world):
    shares = ranks.cpu_shares(range(n_cpus), world)
    assert len(shares) == world
    assert len({len(s) for s in shares}) == 1 and shares[0]
    if n_cpus >= world:
        flat = [c for s in shares for c in s]
        assert len(flat) == len(set(flat)) == world * (n_cpus // world)


@pytest.mark.cuda
def test_rank_cell_on_four_cards(card, checkout):
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip(f"{CELL} needs four cards")
    out = _line(_run(checkout, "--seconds", "3", "--trace", "0", device="cuda",
                     timeout=900))
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert out["device"]["count"] == 4
    assert "compress_gbps" in out["metrics"] and "setup_s" in out["metrics"]
