"""The port's tools and the eval modules that are plain numpy
(dctz_tpu_torch.tools.*, eval.datasets, eval.sz_like, eval.zc_compat)
against dctz_tpu's: the same bytes for the generator, every dataset entry,
the SZ-like codec and the Z-Checker configs; dctz_dump's dict on every
golden container and its extracted streams byte for byte; dct_test's `.x`
and `.r` within the transform's 32-ulp budget (tests/test_torch_core.py).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"
GOLDEN_FILES = sorted(p.name for p in GOLDEN.glob("*.z"))
FIX = pathlib.Path(__file__).parent / "fixtures" / "realdata"
KINDS = ["rand", "smooth", "climate", "spiky", "spectral", "spectral2", "spectral05"]


def _entries():
    from dctz_tpu_torch.eval.datasets import SUITES

    return [(suite, i) for suite, sets in SUITES.items() for i in range(len(sets))]


# ---------------------------------------------------------------------------
# rand_gen and datasets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1000, 4097])
@pytest.mark.parametrize("kind", KINDS)
def test_generate_matches_reference(kind, n):
    from dctz_tpu.tools import rand_gen as jr
    from dctz_tpu_torch.tools import rand_gen as tr

    for seed in (0, 12345):
        a, b = tr.generate(n, kind, seed), jr.generate(n, kind, seed)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_generate_rejects_unknown_kind():
    from dctz_tpu_torch.tools import rand_gen

    with pytest.raises(ValueError, match="unknown kind"):
        rand_gen.generate(10, "nope")


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_rand_gen_main_writes_reference_bytes(tmp_path, capsys, dtype):
    from dctz_tpu.tools import rand_gen as jr
    from dctz_tpu_torch.tools import rand_gen as tr

    argv = ["3000", "--kind", "climate", "--seed", "7", "--dtype", dtype]
    assert tr.main([argv[0], str(tmp_path / "t.bin")] + argv[1:]) == 0
    assert jr.main([argv[0], str(tmp_path / "j.bin")] + argv[1:]) == 0
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    assert "wrote 3000" in capsys.readouterr().out


@pytest.mark.parametrize("suite,i", _entries())
def test_suite_entry_loads_reference_bytes(suite, i):
    """Every entry's synthetic array (the real files are absent here),
    seeded by zlib.crc32 of its name."""
    from dctz_tpu.eval.datasets import SUITES as JS
    from dctz_tpu_torch.eval.datasets import SUITES as TS

    t, j = TS[suite][i], JS[suite][i]
    assert (t.name, t.dims, t.dtype, t.kind, t.path) == (j.name, j.dims, j.dtype,
                                                         j.kind, j.path)
    a, b = t.load(), j.load()
    assert a.dtype == b.dtype == t.np_dtype and a.size == t.n
    assert a.tobytes() == b.tobytes()
    assert t.source() == j.source() == "synthetic"


@pytest.mark.parametrize("name,dims,dtype,path", [
    ("mini", (2560,), "f64", "mini_sedov.bin.f64"),
    ("minif", (32, 128), "f32", "MINI_FIELD_1_32_128.dat"),
])
def test_realdata_fixture_loads_reference_bytes(name, dims, dtype, path):
    from dctz_tpu.eval.datasets import Dataset as JD
    from dctz_tpu_torch.eval.datasets import Dataset as TD

    t, j = TD(name, dims, dtype, "climate", path), JD(name, dims, dtype, "climate", path)
    assert t.source() == "synthetic" and t.source(FIX) == j.source(FIX) == "real"
    a, b = t.load(FIX), j.load(FIX)
    assert a.dtype == t.np_dtype and a.tobytes() == b.tobytes()
    # real bytes, not the generator's
    assert a.tobytes() != t.load().tobytes()


def test_short_real_file_rejected_as_reference(tmp_path):
    from dctz_tpu.eval.datasets import Dataset as JD
    from dctz_tpu_torch.eval.datasets import Dataset as TD

    (tmp_path / "short.bin.f64").write_bytes(b"\0" * 100)
    msgs = []
    for cls in (TD, JD):
        with pytest.raises(ValueError, match="expected >=") as e:
            cls("short", (2560,), "f64", "climate", "short.bin.f64").load(tmp_path)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_parse_list_file_matches_reference(tmp_path):
    from dctz_tpu.eval.datasets import parse_list_file as jp
    from dctz_tpu_torch.eval.datasets import parse_list_file as tp

    for dtype in ("f64", "f32"):
        got = tp(FIX / "list-mini.txt", dtype)
        want = jp(FIX / "list-mini.txt", dtype)
        assert [(e.name, e.dims, e.dtype, e.kind, e.path) for e in got] == [
            (e.name, e.dims, e.dtype, e.kind, e.path) for e in want]
    assert [(e.name, e.dims) for e in tp(FIX / "list-mini.txt")] == [
        ("mini_sedov.bin", (2560,)), ("MINI_FIELD_1_32_128", (32, 128))]
    bad = tmp_path / "bad.txt"
    bad.write_text("a.bin\n")
    with pytest.raises(ValueError, match="no dims"):
        tp(bad)


# ---------------------------------------------------------------------------
# sz_like
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("eb", [1e-3, 1e-5])
def test_sz_like_matches_reference(dtype, eb):
    from dctz_tpu.eval import sz_like as js
    from dctz_tpu_torch.eval import sz_like as ts
    from dctz_tpu_torch.tools.rand_gen import generate

    x = generate(5000, "climate", 3).astype(dtype)
    blob = ts.compress(x, eb)
    assert blob == js.compress(x, eb)
    y = ts.decompress(blob)
    want = js.decompress(blob)
    assert y.dtype == want.dtype == dtype and y.tobytes() == want.tobytes()
    if dtype == np.float64:  # float32 output adds its own rounding
        assert np.abs(y - x).max() <= eb * float(x.max() - x.min())
    with pytest.raises(ValueError, match="not an sz_like container"):
        ts.decompress(b"XXXX" + blob[4:])


# ---------------------------------------------------------------------------
# dctz_dump
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", GOLDEN_FILES)
def test_dump_matches_reference_on_goldens(name):
    from dctz_tpu.tools import dctz_dump as jd
    from dctz_tpu_torch.tools import dctz_dump as td

    path = str(GOLDEN / name)
    got = td.dump(path)
    assert got == jd.dump(path)
    assert got["num_elements"] > 0 and got["format"] in ("v1", "v2")


def test_golden_set_is_complete():
    assert len(GOLDEN_FILES) == 28


def test_dump_dtzs_stream_matches_reference(tmp_path, capsys):
    import dctz_tpu_torch as dz
    from dctz_tpu.tools import dctz_dump as jd
    from dctz_tpu_torch.tools import dctz_dump as td

    x = np.sin(np.arange(70001, dtype=np.float32) * np.float32(0.01)) * np.float32(5)
    cfg = dz.CodecConfig(container="v2", ids_codec="deflate", segment_elems=1 << 15)
    p = tmp_path / "s.z"
    p.write_bytes(dz.compress(x, config=cfg, device="cpu"))
    got = td.dump(str(p))
    assert got == jd.dump(str(p))
    assert got["format"] == "dtzs-stream" and len(got["frames"]) == 3
    assert td.main([str(p)]) == 0
    assert json.loads(capsys.readouterr().out) == got


#: a v1 container of each mode, host-coded v2 (ids4 deflate, rANS, QT with
#: its qtable) and DPK v2 (EC, QT, the DC-delta flag)
EXTRACT = ["golden_v1_ec_f64", "golden_v1_qt_f64", "golden_v2_ec_f32",
           "golden_v2_ec_f32_rans", "golden_v2_qt_f32", "golden_v2_ec_f32_dpk",
           "golden_v2_qt_f32_dpk", "golden_v2_ec_f32_dpk_dcd"]


@pytest.mark.parametrize("name", EXTRACT)
def test_extract_matches_reference(tmp_path, name):
    from dctz_tpu.tools import dctz_dump as jd
    from dctz_tpu_torch import native
    from dctz_tpu_torch.tools import dctz_dump as td

    if "rans" in name and not native.available():
        pytest.skip("the native rANS coder is not built here")
    path = str(GOLDEN / f"{name}.z")
    got = td.extract(path, str(tmp_path / "t"), device="cpu")
    want = jd.extract(path, str(tmp_path / "j"))
    assert [pathlib.Path(p).name[1:] for p in got] == [
        pathlib.Path(p).name[1:] for p in want]
    assert len(got) == (4 if "qt" in name else 3)
    for a, b in zip(got, want):
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes(), a
    ids = np.fromfile(got[0], np.uint8)
    assert ids.size >= td.dump(path)["num_elements"]


def test_extract_dtzs_fails_as_reference(tmp_path):
    import dctz_tpu_torch as dz
    from dctz_tpu.tools import dctz_dump as jd
    from dctz_tpu_torch.tools import dctz_dump as td

    x = np.linspace(0, 1, 9000, dtype=np.float32)
    cfg = dz.CodecConfig(container="v2", ids_codec="deflate", segment_elems=4096)
    p = tmp_path / "s.z"
    p.write_bytes(dz.compress(x, config=cfg, device="cpu"))
    errs = []
    for mod in (td, jd):
        with pytest.raises(Exception) as e:
            mod.extract(str(p), str(tmp_path / "o"))
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]


def test_dump_main_extract_and_device(tmp_path, capsys):
    import shutil

    from dctz_tpu_torch.tools import dctz_dump as td

    p = tmp_path / "g.z"
    shutil.copy(GOLDEN / "golden_v2_ec_f32_dpk.z", p)
    assert td.main([]) == 2
    assert td.main(["--device", "tpu", str(p)]) == 2
    assert td.main(["--extract", "--device", "cpu", str(p)]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out)["filters"]["dpk"]
    assert out.err.count("wrote ") == 3
    if not torch.cuda.is_available():
        # DPK extraction asks for the card unless told otherwise
        with pytest.raises(RuntimeError, match="CUDA"):
            td.extract(str(p))


# ---------------------------------------------------------------------------
# dct_test
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag,dtype", [("-f", np.float32), ("-d", np.float64)])
def test_dct_test_matches_reference(tmp_path, capsys, flag, dtype):
    """.x and .r within 32 eps of the block's max |x| of the reference's
    (the two transforms add their products in other orders); the same three
    lines, max_diff and the oracle's within 32 eps of max |x| of the
    reference's."""
    import jax

    from dctz_tpu.tools import dct_test as jt
    from dctz_tpu_torch.tools import dct_test as tt

    n = 64 * 70 + 37  # a rem-point tail
    x = (np.random.default_rng(5).standard_normal(n) * 40).astype(dtype)
    t, j = tmp_path / "t.bin", tmp_path / "j.bin"
    x.tofile(t)
    x.tofile(j)
    old = jax.config.jax_enable_x64
    try:
        assert jt.main([flag, str(j), str(n)]) == 0
    finally:
        jax.config.update("jax_enable_x64", old)
    want_lines = capsys.readouterr().out.splitlines()
    assert tt.main([flag, str(t), str(n), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split("=")[0].split(":")[0] for ln in lines] == [
        ln.split("=")[0].split(":")[0] for ln in want_lines]
    eps = np.finfo(dtype).eps
    lim = 32 * eps * float(np.abs(x).max())
    # max_diff and the scipy oracle's, each within the budget of the
    # reference's (the transforms' own error is the basis', the same in both)
    for k in (1, 2):
        assert abs(float(lines[k].split("=")[1]) - float(want_lines[k].split("=")[1])) <= lim
    blocks = np.concatenate([x, np.zeros(-n % 64, dtype)]).reshape(-1, 64)
    budget = np.repeat(32 * eps * np.abs(blocks).max(axis=1), 64)[:n]
    for ext in (".x", ".r"):
        a = np.fromfile(str(t) + ext, dtype)
        b = np.fromfile(str(j) + ext, dtype)
        assert a.size == b.size == n
        assert np.all(np.abs(a.astype(np.float64) - b) <= budget), ext


def test_dct_test_usage_and_device(tmp_path):
    from dctz_tpu_torch.tools import dct_test

    src = tmp_path / "x.bin"
    np.ones(100, np.float32).tofile(src)
    assert dct_test.main(["-q"]) == 2
    assert dct_test.main(["-f", str(src), "100", "--device"]) == 2
    assert dct_test.main(["-f", str(src), "200", "--device", "cpu"]) == 1
    assert dct_test.main(["-f", str(src), "100", "--no-write", "--device", "cpu"]) == 0
    assert not (tmp_path / "x.bin.x").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dct_test.main(["-f", str(src), "100"])


# ---------------------------------------------------------------------------
# bin2csv, ncvar2bin, zc_compat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,flag", [(np.float32, "f32"), (np.float64, "f64"),
                                        (np.int32, "i32"), (np.uint8, "u8")])
def test_bin2csv_matches_reference(tmp_path, dtype, flag):
    from dctz_tpu.tools import bin2csv as jb
    from dctz_tpu_torch.tools import bin2csv as tb

    x = (np.random.default_rng(2).standard_normal(50) * 100).astype(dtype)
    src = tmp_path / "x.bin"
    x.tofile(src)
    assert tb.main([str(src), str(tmp_path / "t.csv"), "--dtype", flag]) == 0
    assert jb.main([str(src), str(tmp_path / "j.csv"), "--dtype", flag]) == 0
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "t.csv", delimiter=","), x)


def test_ncvar2bin_matches_reference(tmp_path, capsys):
    from scipy.io import netcdf_file

    from dctz_tpu.tools import ncvar2bin as jn
    from dctz_tpu_torch.tools import ncvar2bin as tn

    nc = tmp_path / "f.nc"
    field = np.arange(6 * 9, dtype=np.float32).reshape(6, 9) * np.float32(0.25)
    with netcdf_file(nc, "w") as f:
        f.createDimension("lat", 6)
        f.createDimension("lon", 9)
        v = f.createVariable("T", "f", ("lat", "lon"))
        v[:] = field
    np.testing.assert_array_equal(tn.read_var(str(nc), "T"), field)
    for dtype in ("f64", "f32"):
        assert tn.main([str(nc), "T", str(tmp_path / "t.bin"), "--dtype", dtype]) == 0
        assert jn.main([str(nc), "T", str(tmp_path / "j.bin"), "--dtype", dtype]) == 0
        assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    capsys.readouterr()
    assert tn.main([str(tmp_path / "missing.nc"), "T", str(tmp_path / "o.bin")]) == 1
    err_t = capsys.readouterr().err
    assert jn.main([str(tmp_path / "missing.nc"), "T", str(tmp_path / "o.bin")]) == 1
    assert err_t == capsys.readouterr().err
    assert "could not read NetCDF file" in err_t


def test_zc_compat_matches_reference_renamed(tmp_path):
    from dctz_tpu.eval import zc_compat as jz
    from dctz_tpu_torch.eval import zc_compat as tz

    assert tz.main(["--out", str(tmp_path / "t")]) == 0
    assert jz.main(["--out", str(tmp_path / "j")]) == 0
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(names) == 4
    for name in names:
        got = (tmp_path / "t" / name).read_text()
        want = (tmp_path / "j" / name).read_text()
        assert got == want.replace("dctz_tpu", "dctz_tpu_torch"), name
    cfg = (tmp_path / "t" / "manageCompressor-dctz-tpu-ec.cfg").read_text()
    assert "-m dctz_tpu_torch.cli " in cfg and "--device" not in cfg
    sh = (tmp_path / "t" / "zc-ratedistortion.sh").read_text()
    assert "-m dctz_tpu_torch.eval.harness" in sh
