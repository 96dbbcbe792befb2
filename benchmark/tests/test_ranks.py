"""The runner of cells of several ranks (harness/ranks.py), on the
four-rank NYX cell. Each run here is made in a copy of the benchmark whose
BENCHMARK.json holds that cell: as BENCHMARK.json itself holds it, once it
does, and until then with STUB's entries added, which are new entries only
(a change that adds the cell may add nothing else). Its CPU rehearsal over
four gloo processes prints the contract's result line, correct, on four
devices; the same run with the timed path broken underneath, in one rank
or in all, comes out `correct` false for each fault the cell can have; a
traced run carries rank 0's spans and counters into its calls, where a
metric added as a new file reads them; a copy of the cell with its slabs
on the device is correct too, and a rank of it that raises ends the run
with no result; the rank skew's readers on made-up calls; the ranks' CPU
shares; on four cards, one short traced run of the cell."""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap
import time

import pytest

from benchmark.harness import ranks, spec, window

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
DEVICE_NAMES = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
CELL = "nyx-ec.4rank"
CONFIG = json.loads(
    (ROOT / "benchmark" / "configs" / "nyx-512-ec-4rank.json").read_text())
# the cell's entries as the change that adds it to BENCHMARK.json may add
# them: new entries only, and the cell in no list that is already there, so
# that it reports `ratio` and `setup_s` end to end
STUB = {
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
    "per_layer": [{"name": f"rank_skew_ms.{k}", "unit": "ms", "better": "lower",
                   "source": "host_clock", "layer": "ranks", "moves": "ratio",
                   "workloads": [CELL]}
                  for k in ("compress", "decompress")],
}
# the same deployment with its slabs on the ranks' devices
DEVICE_CELL = "nyx-ec.4rank-device"
# throwaway per-layer metrics, added as new files: rank 0's counters and
# spans of the ranks' calls
COUNTED = {
    "rank_mark.compress": 'readers.count_per_call(run, "compress", "rank_mark")',
    "rank_mark.decompress": 'readers.count_per_call(run, "decompress", "rank_mark")',
    "probe_ms.compress": 'readers.stage_ms(run, "compress", "multihost.probe")',
    "d2h_pinned_bytes.compress":
        'readers.count_per_call(run, "compress", "bytes_d2h_pinned")',
}
# stands for a span and a counter opened inside parallel/multihost, in
# every process of a run: each call counts its rank + 1 under "rank_mark"
PROBE = """
    from dctz_tpu_torch.parallel import multihost as mh
    from dctz_tpu_torch.utils import timing

    def _probed(real):
        def call(*a, **kw):
            with timing.span("multihost.probe"):
                timing.count("rank_mark", 1 + int(os.environ["RANK"]))
                return real(*a, **kw)
        return call

    mh.compress_multihost = _probed(mh.compress_multihost)
    mh.decompress_multihost = _probed(mh.decompress_multihost)
"""


def with_cell(bench: dict) -> dict:
    """BENCHMARK.json holding the four-rank cell: as it is, once it holds
    it; else with STUB's entries added."""
    out = json.loads(json.dumps(bench))
    if CELL not in {w["name"] for w in out["workloads"]}:
        for key, entries in STUB.items():
            out[key] += entries
    return out


def _digests(d: pathlib.Path) -> dict:
    return {str(p.relative_to(d)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _copy(d: pathlib.Path, bench: dict) -> pathlib.Path:
    """A copy of the benchmark in d, the program linked in, with `bench` as
    its BENCHMARK.json."""
    shutil.copytree(ROOT / "benchmark", d / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("dctz_tpu_torch", "cpp"):
        os.symlink(ROOT / name, d / name)
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    return d


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark whose BENCHMARK.json holds the four-rank
    cell."""
    return _copy(tmp_path_factory.mktemp("ranks"), with_cell(BENCH))


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """The copy, with COUNTED's metrics added as new files and entries:
    (its directory, the digests of benchmark/ before they were added)."""
    d = _copy(tmp_path_factory.mktemp("counted"), with_cell(BENCH))
    before = _digests(d / "benchmark")
    bench = json.loads((d / "BENCHMARK.json").read_text())
    for name, expr in COUNTED.items():
        (d / "benchmark" / "metrics" / f"{name}.py").write_text(
            f'"""A test\'s counter of the ranks\' calls."""\n\n'
            "from benchmark.harness import readers\n\n\n"
            f"def read(run):\n    return {expr}\n")
        bench["per_layer"].append(
            {"name": name, "unit": "count", "better": "lower",
             "source": "program_counter", "layer": "ranks", "moves": "ratio",
             "workloads": [CELL]})
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    return d, before


@pytest.fixture(scope="module")
def device_checkout(tmp_path_factory):
    """A copy whose BENCHMARK.json holds the four-rank deployment over the
    traffic with the fields on the device."""
    bench = with_cell(BENCH)
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    bench["workloads"].append(dict(cell, name=DEVICE_CELL, traffic="insitu"))
    return _copy(tmp_path_factory.mktemp("device"), bench)


def _run(checkout, *args, env=None, device="cpu", timeout=600, cell=CELL):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**32 + 11), *args, "--device", device],
        cwd=checkout, capture_output=True, text=True, timeout=timeout, env=env)


def _line(p) -> dict:
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _planted(tmp_path, checkout, source: str) -> dict:
    """The environment of a run in `checkout` whose every process imports
    `source` first (a sitecustomize module; RANK tells the ranks it starts
    apart)."""
    (tmp_path / "sitecustomize.py").write_text(
        "import os\n" + textwrap.dedent(source))
    return dict(os.environ, PYTHONPATH=f"{tmp_path}:{checkout}")


def test_cell_entries_keep_the_contract(tmp_path):
    bench = with_cell(BENCH)
    for key, entries in bench.items():  # what BENCHMARK.json has, unchanged
        if isinstance(entries, list):
            assert entries[:len(BENCH[key])] == BENCH[key], key
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(CELL, tmp_path / "BENCHMARK.json")
    assert cell.chips == CONFIG["chips"] == 4 and CONFIG["reduced"] == []
    assert cell.traffic["residency"] in ("host", "device")
    ends = {m["name"] for m in cell.end_to_end}
    assert {"ratio", "setup_s"} <= ends
    assert {"rank_skew_ms.compress", "rank_skew_ms.decompress"} <= {
        m["name"] for m in cell.per_layer}
    for m in cell.per_layer:
        assert m["moves"] in ends
        assert callable(spec.reader(m["name"]))
    for key in ("configs", "workloads"):
        assert all(len(e["why"]) <= 200 for e in bench[key])
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)


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
    cell = spec.load_cell(CELL, checkout / "BENCHMARK.json")
    if trace == "0":
        assert names == {m["name"] for m in cell.end_to_end}
    else:  # the trace's readers find no card; the ranks' skew is the host's
        assert names <= {m["name"] for m in cell.per_layer}
        assert {"rank_skew_ms.compress", "rank_skew_ms.decompress"} <= names
        assert all(v["value"] >= 0.0 for v in out["metrics"].values())


@pytest.mark.parametrize("trace", ["0", "1"])
def test_traced_rank_calls_carry_rank_0s_spans_and_counts(counted, tmp_path,
                                                          trace):
    """Metrics added as new files read rank 0's counter and span of the
    ranks' calls in a traced run, and nothing in an untraced one; no file
    of the benchmark changed."""
    d, before = counted
    out = _line(_run(d, "--seconds", "1", "--trace", trace,
                     env=_planted(tmp_path, d, PROBE)))
    assert out["correct"] is True
    got = {k.removeprefix("cpu_rehearsal."): v["value"]
           for k, v in out["metrics"].items()}
    if trace == "0":
        assert not set(got) & set(COUNTED)
    else:
        # rank 0 counts 1 a call, rank r r + 1
        assert got["rank_mark.compress"] == got["rank_mark.decompress"] == 1.0
        assert got["probe_ms.compress"] > 0.0
        assert "d2h_pinned_bytes.compress" not in got  # no card, no pinned copy
    after = _digests(d / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_rank_slabs_on_the_device(device_checkout):
    out = _line(_run(device_checkout, "--seconds", "1", "--trace", "0",
                     cell=DEVICE_CELL))
    assert out["correct"] is True and out["failed"] == 0
    assert out["device"]["count"] == 4


def test_failing_rank_with_device_slabs_ends_the_run(device_checkout, tmp_path):
    """A rank that raises in its compress ends the run, with no result and
    well inside a run's 360 seconds, though the other ranks wait for it in
    a collective."""
    env = _planted(tmp_path, device_checkout, """
        if os.environ.get("RANK") == "2":
            from dctz_tpu_torch.parallel import multihost as mh
            def compress_multihost(*a, **kw):
                raise RuntimeError("a rank's compress fails")
            mh.compress_multihost = compress_multihost
    """)
    t0 = time.monotonic()
    p = _run(device_checkout, "--seconds", "1", "--trace", "0", env=env,
             cell=DEVICE_CELL, timeout=360)
    assert p.returncode != 0 and not p.stdout.strip()
    assert "a rank's compress fails" in p.stderr
    assert time.monotonic() - t0 < 180


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
    env = _planted(tmp_path, checkout, FAULTS[fault])
    out = _line(_run(checkout, "--seconds", "0.5", "--trace", "0", env=env))
    assert out["correct"] is False, out["checks"]


def _calls(kind, rank_seconds):
    return [ranks.RankCall(kind, 0, max(rs), 4, 1, rank_seconds=tuple(rs))
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
def test_rank_cell_on_four_cards(card, counted):
    """One short traced run of the cell on four cards: correct, and rank 0's
    compress calls carry the program's count of bytes pulled into pinned
    host memory."""
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip(f"{CELL} needs four cards")
    d, _ = counted
    out = _line(_run(d, "--seconds", "3", "--trace", "1", device="cuda",
                     timeout=900))
    print(json.dumps(out))  # shown with -rP
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert out["device"]["count"] == 4
    assert out["metrics"]["d2h_pinned_bytes.compress"]["value"] > 0
    assert "rank_skew_ms.compress" in out["metrics"]
