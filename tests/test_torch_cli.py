"""The port's CLI (dctz_tpu_torch.cli, --device cpu) against dctz_tpu.cli on
the same argv and the same input file: the same stdout lines (the JSON
line's keys and values but the four timings), the same `.z` bytes and the
same `.z.r` array, and each package decoding the other's `.z`.

Containers are held byte for byte by test_torch_oracle.assert_byte_equal:
the header's mean of float32 data within MEAN_ULPS (a float32 sum in
another order), of float64 data not compared; the port's transforms and
QT renormalization set to the reference's XLA CPU arithmetic
(ref_arithmetic), as in tests/test_torch_truncate.py, and, for the
`.z.r` arrays, the QT inverse's division by the constant eb * qt_factor
set to XLA's (ref_inverse). DPK frames of
the fused route may differ by a bin-edge flip of the Pallas kernel's own
transform (edge_flips).

The reference's CLI turns x64 on for -d (dctz_tpu/cli.py:131-135), so
the float64 cases come first, as tests/conftest.py leaves x64 on; the
float32 cases come last, under the module-scoped `oracle` fixture (x64
off, the fused dispatch forced), the layout of tests/test_torch_f64.py.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_oracle import (  # noqa: F401
    assert_byte_equal, oracle, ref_arithmetic, ref_inverse,
)

torch.set_num_threads(2)

#: the JSON line's values that are clocks
TIMINGS = ("compress_s", "decompress_s", "mb_per_s_compress", "mb_per_s_decompress")


def _bound_of(argv, x):
    return float(argv[1]) * float(x.max() - x.min())


def _run_both(tmp_path, capsys, argv, x, name="var.bin"):
    """Run both CLIs on copies of x in two directories under the same file
    name; returns {side: (stdout lines, .z bytes or None, .z.r or None)}."""
    from dctz_tpu.cli import main as jax_main
    from dctz_tpu_torch.cli import main as torch_main

    out = {}
    for side, fn, extra in (("jax", jax_main, []),
                            ("torch", torch_main, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        src = d / name
        x.tofile(src)
        args = [a.replace("@", str(src)) for a in argv] + extra
        capsys.readouterr()
        assert fn(args) == 0
        lines = capsys.readouterr().out.replace(str(d), "<dir>").splitlines()
        mode = argv[argv.index("--mode") + 1] if "--mode" in argv else "ec"
        z = d / f"{name}.{mode}.{argv[1]}.z"
        r = z.with_suffix(".z.r")
        out[side] = (lines, z.read_bytes() if z.exists() else None,
                     np.fromfile(r, x.dtype) if r.exists() else None)
    return out


def _check(out, argv, x, edge_flips=False, cross=True):
    import dctz_tpu
    import dctz_tpu_torch as dz

    (lj, zj, rj), (lt, zt, rt) = out["jax"], out["torch"]
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        if a.startswith("{"):
            ma, mb = json.loads(a), json.loads(b)
            assert list(ma) == list(mb)
            assert ({k: v for k, v in ma.items() if k not in TIMINGS}
                    == {k: v for k, v in mb.items() if k not in TIMINGS})
        else:
            assert a == b
    if "--no-write" in argv:
        assert zj is zt is None and rj is rt is None
        return
    assert_byte_equal(zt, zj, x, edge_flips=edge_flips)
    assert rt.dtype == x.dtype and np.array_equal(rt, rj)
    if not cross:
        return
    # each package decodes the other's container to the other's .z.r
    assert np.array_equal(dz.decompress(zj, device="cpu"), rj)
    assert np.array_equal(np.asarray(dctz_tpu.decompress(zt)), rt)
    if "--verify" in argv:
        assert np.abs(rt - x).max() <= _bound_of(argv, x)


def _f64(n=6400, seed=0):
    return np.random.default_rng(seed).standard_normal(n) * 20


# ---------------------------------------------------------------------------
# float64 (-d): x64 on, as tests/conftest.py leaves it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["1E-3", "testvar", "@", "6400"],
    ["1E-4", "v", "@", "6400", "--mode", "qt", "--json"],
    ["1E-3", "v", "@", "80", "80", "sol(1E-3)", "--json"],
    ["1E-3", "v", "@", "6400", "--container", "v2", "--ids-codec", "device",
     "--verify", "--json"],
    ["1E-3", "v", "@", "6400", "--no-write"],
], ids=["ec", "qt_json", "2d_solname", "v2_device", "no_write"])
def test_double_matches_reference(tmp_path, capsys, ref_arithmetic,
                                  ref_inverse, argv):
    x = _f64()
    out = _run_both(tmp_path, capsys, ["-d"] + argv, x)
    _check(out, ["-d"] + argv, x)


def test_native_matches_reference(tmp_path, capsys):
    from dctz_tpu_torch import native

    if not native.available():
        pytest.skip("native codec not built")
    x = np.sin(np.linspace(0, 20, 5000)) * 7
    argv = ["-d", "1E-3", "v", "@", "5000", "--native", "--json"]
    out = _run_both(tmp_path, capsys, argv, x)
    assert out["jax"][1] == out["torch"][1]
    # the C codec's decode on both sides; the packages' own decoders are
    # held apart (tests/test_torch_f64.py)
    _check(out, argv, x, cross=False)


@pytest.fixture
def reference_mesh(monkeypatch):
    """--sharded: the reference's CLI shards over its default mesh, every
    JAX device (tests/conftest.py's 8 virtual host devices), and resolves
    ids_codec "auto" for v2 to the device ids on its accelerator only
    (tests/test_torch_eval.py's auto_means_device); the port's CLI here
    shards over as many CPU devices, and takes the device ids on every
    device."""
    import dataclasses

    import jax

    from dctz_tpu import api as ja
    from dctz_tpu_torch.parallel import sharding as sh

    n = len(jax.devices())
    monkeypatch.setattr(sh, "mesh_for", lambda mesh, device: [torch.device("cpu")] * n)

    def resolve(cfg):
        if cfg.ids_codec == "auto" and cfg.container == "v2":
            return dataclasses.replace(cfg, ids_codec="device")
        return cfg

    monkeypatch.setattr(ja, "_resolve_ids_codec", resolve)


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_sharded_double_matches_reference(tmp_path, capsys, ref_arithmetic, ref_inverse,
                                          reference_mesh, mode):
    """-d --sharded: compress_sharded at full width over 8 shards."""
    x = _f64(6400, 3)
    argv = ["-d", "1E-3", "v", "@", "6400", "--sharded", "--mode", mode, "--json"]
    out = _run_both(tmp_path, capsys, argv, x)
    _check(out, argv, x)


def test_usage_and_bad_input(tmp_path, capsys):
    from dctz_tpu_torch.cli import main

    assert main([]) == 2
    assert main(["-x", "1E-3"]) == 2
    src = tmp_path / "short.bin"
    np.ones(10, np.float32).tofile(src)
    assert main(["-f", "1E-3", "v", str(src), "100", "--device", "cpu"]) == 1
    assert main(["-f", "1E-3", "v", str(src), "sol"]) == 2
    assert "Error reading file" in capsys.readouterr().err


def test_device_defaults_to_cuda(tmp_path):
    """Without --device the CLI asks for the card, and raises without one."""
    from dctz_tpu_torch.cli import build_parser, main

    assert build_parser().parse_args(["1E-3", "v", "f", "8"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only behaviour")
    src = tmp_path / "c.bin"
    np.ones(4096, np.float32).tofile(src)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-f", "1E-3", "v", str(src), "4096", "--no-write"])


# ---------------------------------------------------------------------------
# float32 (-f) under the oracle (x64 off from here to the end of the module)
# ---------------------------------------------------------------------------


def _f32(n, seed=1):
    t = np.arange(n, dtype=np.float32)
    rng = np.random.default_rng(seed)
    return (np.sin(t * np.float32(0.003)) * np.float32(9.0)
            + rng.standard_normal(n).astype(np.float32) * np.float32(0.3))


@pytest.mark.parametrize("argv,n", [
    (["1E-3", "v", "@", "80", "25", "sol(1E-3)", "--no-write"], 2000),
    (["1E-3", "v", "@", "5000", "--json"], 5000),
    (["1E-3", "v", "@", "5000", "--mode", "qt", "--verify"], 5000),
    (["1E-3", "v", "@", "16384", "--json"], 16384),
    (["1E-3", "v", "@", "40000", "--container", "v2", "--ids-codec", "device",
      "--json"], 40000),
    (["1E-3", "v", "@", "40000", "--container", "v2", "--ids-codec", "device",
      "--mode", "qt", "--verify", "--json"], 40000),
    (["1E-3", "v", "@", "5000", "--container", "v2", "--ids-codec", "deflate",
      "--verify"], 5000),
], ids=["2d_solname_no_write", "generic_json", "generic_qt", "fused_v1",
        "v2_device", "v2_device_qt", "v2_deflate"])
def test_float_matches_reference(tmp_path, capsys, oracle, ref_arithmetic,
                                 ref_inverse, argv, n):
    x = _f32(n)
    out = _run_both(tmp_path, capsys, ["-f"] + argv, x)
    _check(out, ["-f"] + argv, x, edge_flips="device" in argv)


def test_sharded_float_matches_reference(tmp_path, capsys, oracle, ref_arithmetic,
                                         ref_inverse, reference_mesh):
    """-f --sharded: compress_sharded over 8 shards, kernels A + B per
    shard (the reference's Pallas kernel in interpret mode: edge flips).
    --sharded takes no config in either CLI: no verify, whatever the
    flags."""
    x = _f32(40000)
    argv = ["-f", "1E-3", "v", "@", "40000", "--sharded", "--json"]
    out = _run_both(tmp_path, capsys, argv, x)
    _check(out, argv, x, edge_flips=True)
