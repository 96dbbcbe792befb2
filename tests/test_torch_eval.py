"""The port's evaluation harness (dctz_tpu_torch.eval.harness, device="cpu")
against dctz_tpu.eval.harness: each row equal to the reference's in every
field but the compressor's name (dctz_{mode}_torch against _jax) and the two
speeds, the same CSV columns, and the engines the port keeps.

Rows hold the metrics of the decode (PSNR, max relative error, SSIM), so
the decodes must be bit-equal: the port's transforms and QT
renormalization run the reference's XLA CPU arithmetic (ref_arithmetic),
and its QT inverse too (ref_inverse), as in tests/test_torch_cli.py.
Float64 cases run first, with x64 on as tests/conftest.py leaves it (the
reference's harness turns it on for its CPU backend); float32 cases come
last, under the module-scoped `oracle` fixture (x64 off).
"""

import csv

import numpy as np
import pytest
import torch

from test_torch_oracle import (  # noqa: F401
    oracle, ref_arithmetic, ref_inverse,
)

torch.set_num_threads(2)

SPEEDS = ("compress_mb_s", "decompress_mb_s")


def _same_row(got: dict, want: dict, renamed: bool = True) -> None:
    assert list(got) == list(want)
    for k in want:
        if k in SPEEDS:
            continue
        if k == "compressor" and renamed:
            assert want[k].endswith("_jax") and got[k] == want[k][:-4] + "_torch"
        elif isinstance(want[k], float) and np.isnan(want[k]):
            assert np.isnan(got[k])
        else:
            assert got[k] == want[k], k


@pytest.fixture
def auto_means_device(monkeypatch):
    """The reference's rule for ids_codec="auto" on its accelerator, which
    the port follows on every device (dctz_tpu_torch/api.py
    _resolve_ids_codec): a v2 container takes the device (DPK) id coder.
    On the CPU the reference takes its host coders instead."""
    import dataclasses

    from dctz_tpu import api as ja

    def resolve(cfg):
        if cfg.ids_codec == "auto" and cfg.container == "v2":
            return dataclasses.replace(cfg, ids_codec="device")
        return cfg

    monkeypatch.setattr(ja, "_resolve_ids_codec", resolve)


def _datasets(dtype):
    from dctz_tpu.eval import datasets as jd
    from dctz_tpu_torch.eval import datasets as td

    kind = "climate"
    return (td.Dataset("toy9000", (9000,), dtype, kind),
            jd.Dataset("toy9000", (9000,), dtype, kind))


# ---------------------------------------------------------------------------
# float64: x64 on
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("which", ["msst19", "toy9000"])
def test_run_one_f64_matches_reference(ref_arithmetic, ref_inverse, which, mode):
    from dctz_tpu.eval import harness as jh
    from dctz_tpu.eval.datasets import MSST19 as JM
    from dctz_tpu_torch.eval import harness as th
    from dctz_tpu_torch.eval.datasets import MSST19 as TM

    t, j = (TM[0], JM[0]) if which == "msst19" else _datasets("f64")
    got = th.run_one(t, 1e-3, mode, device="cpu")
    want = jh.run_one(j, 1e-3, mode)
    _same_row(got, want)
    assert got["compressor"] == f"dctz_{mode}_torch" and got["bound_satisfied"]
    assert got["dtype"] == "f64" and got["source"] == "synthetic"


def test_run_one_auto_engine_matches_reference(ref_arithmetic, auto_means_device):
    """engine="auto": v2, rate="auto", verify forced on (its row says so)."""
    from dctz_tpu.eval import harness as jh
    from dctz_tpu_torch.eval import harness as th

    t, j = _datasets("f64")
    got = th.run_one(t, 1e-4, "ec", "auto", verify=False, device="cpu")
    _same_row(got, jh.run_one(j, 1e-4, "ec", "auto", verify=False), renamed=False)
    assert got["compressor"] == "dctz_ec_auto" and got["bound_satisfied"]


def test_run_one_native_engine_matches_reference():
    from dctz_tpu.eval import harness as jh
    from dctz_tpu_torch import native
    from dctz_tpu_torch.eval import harness as th

    if not native.available():
        pytest.skip("native codec not built")
    t, j = _datasets("f64")
    got = th.run_one(t, 1e-3, "qt", "native", device="cpu")
    _same_row(got, jh.run_one(j, 1e-3, "qt", "native"), renamed=False)
    assert got["compressor"] == "dctz_qt_native"


@pytest.mark.parametrize("eb", [1e-3, 1e-5])
def test_run_sz_like_matches_reference(eb):
    from dctz_tpu.eval import harness as jh
    from dctz_tpu.eval.datasets import MSST19 as JM
    from dctz_tpu_torch.eval import harness as th
    from dctz_tpu_torch.eval.datasets import MSST19 as TM

    got = th.run_sz_like(TM[2], eb)
    _same_row(got, jh.run_sz_like(JM[2], eb), renamed=False)
    assert got["compressor"] == "sz_like" and got["bound_satisfied"]


@pytest.mark.parametrize("codec", ["zlib", "lzma", "bz2"])
def test_run_lossless_baseline_matches_reference(codec):
    from dctz_tpu.eval import harness as jh
    from dctz_tpu_torch.eval import harness as th

    t, j = _datasets("f32")
    got = th.run_lossless_baseline(t, codec)
    _same_row(got, jh.run_lossless_baseline(j, codec), renamed=False)
    assert got["compressor"] == codec and np.isnan(got["decompress_mb_s"])


@pytest.fixture
def tiny_suite(monkeypatch):
    """One 4096-element float64 entry as the "randgen" suite in both
    packages."""
    from dctz_tpu.eval import datasets as jd
    from dctz_tpu.eval import harness as jh
    from dctz_tpu_torch.eval import datasets as td
    from dctz_tpu_torch.eval import harness as th

    for mod, ds in ((th, td), (jh, jd)):
        suites = dict(ds.SUITES, randgen=[ds.Dataset("tiny", (4096,), "f64", "smooth")])
        monkeypatch.setattr(mod, "SUITES", suites)


def test_sweep_matches_reference_and_main_writes_its_columns(
        tmp_path, capsys, ref_arithmetic, ref_inverse, tiny_suite):
    from dctz_tpu.eval import harness as jh
    from dctz_tpu_torch.eval import harness as th

    kw = dict(bounds=(1e-3,), modes=("ec", "qt"), progress=lambda *_: None)
    got = th.sweep("randgen", device="cpu", **kw)
    want = jh.sweep("randgen", **kw)
    assert [r["compressor"] for r in got] == [
        "zlib", "sz_like", "dctz_ec_torch", "dctz_qt_torch"]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same_row(a, b, renamed=a["compressor"].startswith("dctz_"))
    out = tmp_path / "rows.csv"
    assert th.main(["--suite", "randgen", "--bounds", "1e-3", "--modes", "ec",
                    "--device", "cpu", "--out", str(out)]) == 0
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == list(want[0]) and len(rows) == 4
    assert "wrote 3 rows" in capsys.readouterr().err


def test_psnr_curve_matches_reference(ref_arithmetic, auto_means_device, tiny_suite):
    from dctz_tpu.eval import harness as jh
    from dctz_tpu_torch.eval import harness as th

    got = th.psnr_curve("randgen", progress=lambda *_: None, bounds=(1e-3,),
                        device="cpu")
    want = jh.psnr_curve("randgen", progress=lambda *_: None, bounds=(1e-3,))
    assert [r["compressor"] for r in got] == ["sz_like", "dctz_ec_auto"]
    for a, b in zip(got, want):
        # the reference tests its rows' dtype against "float64" where they
        # say "f64", and so counts float64 at 32 bits; the port counts the
        # dtype's own bits
        assert a["dtype"] == b["dtype"] == "f64"
        assert a["bits_per_value"] == round(64 / b["ratio"], 4)
        _same_row(a, dict(b, bits_per_value=a["bits_per_value"]), renamed=False)


@pytest.fixture
def reference_mesh(monkeypatch):
    """The sharded engine: the reference's shards over every JAX device
    (tests/conftest.py's 8 virtual host devices); the port's here over as
    many CPU devices."""
    import jax

    from dctz_tpu_torch.parallel import sharding as sh

    n = len(jax.devices())
    monkeypatch.setattr(sh, "mesh_for", lambda mesh, device: [torch.device("cpu")] * n)


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_sharded_engine_f64_matches_reference(ref_arithmetic, ref_inverse, auto_means_device,
                                              reference_mesh, mode):
    """engine="sharded": compress_sharded / decompress_sharded over 8
    shards; and a sweep of that engine."""
    from dctz_tpu.eval import harness as jh
    from dctz_tpu_torch.eval import harness as th

    t, j = _datasets("f64")
    got = th.run_one(t, 1e-3, mode, "sharded", device="cpu")
    _same_row(got, jh.run_one(j, 1e-3, mode, "sharded"), renamed=False)
    assert got["compressor"] == f"dctz_{mode}_sharded" and got["bound_satisfied"]


def test_sharded_engine_sweep_matches_reference(ref_arithmetic, ref_inverse, auto_means_device,
                                                reference_mesh, tiny_suite):
    from dctz_tpu.eval import harness as jh
    from dctz_tpu_torch.eval import harness as th

    kw = dict(bounds=(1e-3,), modes=("ec",), engines=("sharded",), progress=lambda *_: None)
    got = th.sweep("randgen", device="cpu", **kw)
    want = jh.sweep("randgen", **kw)
    assert [r["compressor"] for r in got] == ["zlib", "sz_like", "dctz_ec_sharded"]
    for a, b in zip(got, want):
        _same_row(a, b, renamed=False)


def test_data_dir_row_says_real():
    import pathlib

    from dctz_tpu_torch.eval.datasets import Dataset
    from dctz_tpu_torch.eval.harness import run_one

    fix = pathlib.Path(__file__).parent / "fixtures" / "realdata"
    ds = Dataset("mini", (2560,), "f64", "climate", "mini_sedov.bin.f64")
    row = run_one(ds, 1e-3, "ec", data_dir=str(fix), device="cpu")
    assert row["source"] == "real" and row["bound_satisfied"]
    assert run_one(ds, 1e-3, "ec", device="cpu")["source"] == "synthetic"


def test_device_defaults_to_cuda():
    import inspect

    from dctz_tpu_torch.eval import harness as th

    for fn in (th.run_one, th.sweep, th.psnr_curve):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(th.run_one).parameters["engine"].default == "torch"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only behaviour")
    t, _ = _datasets("f32")
    with pytest.raises(RuntimeError, match="CUDA"):
        th.run_one(t, 1e-3, "ec")


# ---------------------------------------------------------------------------
# float32 under the oracle (x64 off from here to the end of the module)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_run_one_f32_matches_reference(oracle, ref_arithmetic, ref_inverse, mode):
    from dctz_tpu.eval import harness as jh
    from dctz_tpu_torch.eval import harness as th

    t, j = _datasets("f32")
    got = th.run_one(t, 1e-3, mode, device="cpu")
    _same_row(got, jh.run_one(j, 1e-3, mode))
    assert got["dtype"] == "f32" and got["bound_satisfied"]


def test_sharded_engine_f32_matches_reference(oracle, ref_arithmetic, ref_inverse,
                                              reference_mesh):
    from dctz_tpu.eval import harness as jh
    from dctz_tpu_torch.eval import harness as th

    t, j = _datasets("f32")
    got = th.run_one(t, 1e-3, "ec", "sharded", device="cpu")
    _same_row(got, jh.run_one(j, 1e-3, "ec", "sharded"), renamed=False)
    assert got["dtype"] == "f32" and got["bound_satisfied"]
