"""eval/run_suites_torch.sh, the port's suite runner, against
eval/run_suites.sh, the JAX package's: the same seven harness calls in the
same order, each the reference's argv with only the module
(dctz_tpu_torch.eval.harness), the engine ("jax" is "torch") and the output
(eval/results_torch_<suffix>.csv) changed, and the same data-directory
handling; each call parsed by the port's harness drives its sweep on the
default device, the card. The committed eval/results_torch_*.csv (the
sweeps' rows from the card) hold the reference files' rows in order and the
bound wherever the reference's row holds it.
"""

import csv
import pathlib
import shlex

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "eval" / "run_suites.sh"
PORT = ROOT / "eval" / "run_suites_torch.sh"
REF_MODULE, PORT_MODULE = "dctz_tpu.eval.harness", "dctz_tpu_torch.eval.harness"


def _script(path: pathlib.Path):
    """(the commands before the first harness call, the argv of each
    harness call, the commands after the last)"""
    pre, calls, post = [], [], []
    for line in path.read_text().splitlines():
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        if s.startswith("python -m "):
            calls.append(shlex.split(s))
        else:
            (post if calls else pre).append(s)
    return pre, calls, post


def _option(argv: list, name: str) -> list:
    """The values after option `name` up to the next option."""
    if name not in argv:
        return []
    i = argv.index(name) + 1
    j = i
    while j < len(argv) and not argv[j].startswith("--") and argv[j] != "$DATA":
        j += 1
    return argv[i:j]


def _as_port(argv: list) -> list:
    """The reference's harness call as the port's: module, engine and output
    renamed, nothing else."""
    out = []
    for k, tok in enumerate(argv):
        if tok == REF_MODULE:
            tok = PORT_MODULE
        elif tok == "jax" and "--engines" in argv[:k]:
            tok = "torch"
        elif argv[k - 1] == "--out":
            path = pathlib.PurePosixPath(tok)
            assert path.name.startswith("results_"), tok
            tok = str(path.with_name("results_torch_" + path.name[len("results_"):]))
        out.append(tok)
    return out


def test_seven_sweeps_are_the_references():
    _pre, ref, _post = _script(REF)
    _pre, port, _post = _script(PORT)
    assert len(ref) == len(port) == 7
    for r, p in zip(ref, port):
        assert p == _as_port(r)
        assert p[:3] == ["python", "-m", PORT_MODULE]
        assert "jax" not in p


def test_data_dir_and_exit_handling_are_the_references():
    ref_pre, _calls, ref_post = _script(REF)
    port_pre, _calls, port_post = _script(PORT)
    assert port_pre == ref_pre
    assert port_pre[0] == "set -e"
    assert port_post == ref_post


def test_outputs_are_the_ports_own():
    """Each call writes its own eval/results_torch_*.csv beside a committed
    reference file of the same suffix, and no reference file."""
    _pre, ref, _post = _script(REF)
    _pre, port, _post = _script(PORT)
    outs = [_option(p, "--out") for p in port]
    assert all(len(o) == 1 for o in outs)
    outs = [o[0] for o in outs]
    assert len(set(outs)) == 7
    for o, r in zip(outs, ref):
        assert o.startswith("eval/results_torch_") and o.endswith(".csv")
        assert o != _option(r, "--out")[0]
        assert (ROOT / _option(r, "--out")[0]).exists()


@pytest.mark.parametrize("line", range(7))
@pytest.mark.parametrize("data_dir", [None, "/data/sets"])
def test_each_call_drives_the_ports_harness_on_the_card(monkeypatch, tmp_path, line,
                                                        data_dir):
    """Each harness call, as the shell expands it, parsed by the port's
    harness: the sweep (or the matched-PSNR curve) of its suite, bounds,
    modes and engines on the default device, the card, and its rows written
    to its --out."""
    from dctz_tpu_torch.eval import harness

    _pre, port, _post = _script(PORT)
    argv = port[line][3:]
    data = ["--data-dir", data_dir] if data_dir else []
    k = argv.index("$DATA")
    argv = argv[:k] + data + argv[k + 1:]
    out = tmp_path / "rows.csv"
    argv[argv.index("--out") + 1] = str(out)
    calls = []

    def fake(name):
        def run(suite, *args, **kw):
            calls.append((name, suite, args, kw))
            return [{"compressor": "c", "dataset": suite}]
        return run

    monkeypatch.setattr(harness, "sweep", fake("sweep"))
    monkeypatch.setattr(harness, "psnr_curve", fake("psnr_curve"))
    assert harness.main(argv) == 0
    (name, suite, args, kw), = calls
    assert suite == _option(argv, "--suite")[0]
    assert kw["data_dir"] == data_dir
    assert kw.get("device", "cuda") == "cuda"
    if "--psnr-curve" in argv:
        assert name == "psnr_curve" and not args
    else:
        bounds, modes, engines = args
        assert name == "sweep" and kw["verify"]
        assert list(bounds) == list(harness.DEFAULT_BOUNDS)
        assert modes == _option(argv, "--modes")
        assert engines == _option(argv, "--engines")
    assert out.read_text().splitlines()[1] == f"c,{suite}"


def test_harness_has_no_cpu_fallback(monkeypatch):
    """Without a card the sweep's first dctz row fails, as the harness's
    default device is the card."""
    import torch

    from dctz_tpu_torch.eval import harness
    from dctz_tpu_torch.eval.datasets import MSST19

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        harness.run_one(MSST19[2], 1e-3, "ec")


def _rows(path: pathlib.Path) -> tuple:
    with open(path, newline="") as f:
        r = csv.DictReader(f)
        return r.fieldnames, list(r)


#: the compressors whose rows the reference's CSVs hold (chip_smoke.py's
#: REFERENCE_HELD)
REFERENCE_HELD = ("_torch", "_native", "sz_like", "zlib")
#: the committed pairs: the reference's CSV and the port's, by suffix
CSVS = [_option(c, "--out")[0] for c in _script(REF)[1]]


@pytest.mark.parametrize("ref_csv", CSVS)
def test_committed_rows_match_the_references_rows(ref_csv):
    """The port's committed CSV (the sweep on the card) has the reference's
    columns and rows in the same order, keyed by (compressor, dataset,
    source, dtype, n, error_bound, verify) with "_jax" named "_torch"; every
    dctz row whose reference row satisfies the bound satisfies it too. The
    torch, native, sz_like and zlib rows match the reference's within 0.1%
    in ratio and 0.01 dB in PSNR (chip_smoke.py's suites phase holds the
    card's live rows so); the auto and sharded rows need not: the
    reference resolved ids_codec="auto" by its CPU rule (host coders), the
    port by its accelerator's (DPK)."""
    ref_path = ROOT / ref_csv
    port_path = ref_path.with_name("results_torch_" + ref_path.name[len("results_"):])
    ref_cols, ref_rows = _rows(ref_path)
    port_cols, port_rows = _rows(port_path)
    assert port_cols == ref_cols
    assert len(port_rows) == len(ref_rows)
    keys = ("compressor", "dataset", "source", "dtype", "n", "error_bound", "verify")
    for p, r in zip(port_rows, ref_rows):
        want = dict(r, compressor=r["compressor"].replace("_jax", "_torch"))
        assert [p[k] for k in keys] == [want[k] for k in keys]
        if r["bound_satisfied"] == "True":
            assert p["bound_satisfied"] == "True", p
        if p["compressor"].endswith(REFERENCE_HELD):
            assert abs(float(p["ratio"]) / float(r["ratio"]) - 1.0) <= 1e-3, (p, r)
            if p["psnr_db"] != "inf" or r["psnr_db"] != "inf":
                assert abs(float(p["psnr_db"]) - float(r["psnr_db"])) <= 0.01, (p, r)
