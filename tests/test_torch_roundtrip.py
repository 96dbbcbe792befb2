"""The ported slice end to end on the CPU: round trips, containers decoded
both ways between the port and dctz_tpu, the DPK EC goldens, the ratio, and
the configurations that are not ported yet."""

import json
import pathlib

import numpy as np
import pytest
import torch

from test_torch_oracle import EPS32, TILE_N, bound, oracle, signal, slice_cfg  # noqa: F401

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"
DPK_EC_GOLDENS = [
    "golden_v2_ec_f32_dpk",
    "golden_v2_ec_f32_dpk_dcd",
    "golden_v2_ec_f32_dpk_legacyhdrcrc",
    "golden_v2_ec_f32_dpk_legacyplc",
    "golden_v2_ec_f32_dpk_legacyzstd",
]
SIZES = [2 * TILE_N, 5 * TILE_N - 11]


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_port_round_trip_holds_bound(n, verify):
    import dctz_tpu_torch as dz

    x = signal(n, n)
    blob = dz.compress(x, config=slice_cfg(dz, verify=verify), device="cpu")
    y = dz.decompress(blob, device="cpu")
    assert y.dtype == np.float32 and y.shape == x.shape
    res = dz.evaluate(x, y, 1e-3)
    assert res["bound_satisfied"], res


@pytest.mark.parametrize("n", SIZES)
def test_port_container_decodes_in_reference(oracle, n):
    import dctz_tpu
    import dctz_tpu_torch as dz

    x = signal(n, n + 1)
    blob = dz.compress(x, config=slice_cfg(dz), device="cpu")
    y = np.asarray(dctz_tpu.decompress(blob))
    assert np.abs(y - x).max() <= bound(x)


@pytest.mark.parametrize("n", SIZES)
def test_reference_container_decodes_in_port(oracle, n):
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu.core import container as ct

    x = signal(n, n + 2)
    blob = dctz_tpu.compress(x, config=slice_cfg(dctz_tpu))
    ref = np.asarray(dctz_tpu.decompress(blob))
    got = dz.decompress(blob, device="cpu")
    assert np.abs(got - x).max() <= bound(x)
    sf = ct.parse_v2(blob)[0].scaling_factor
    assert np.abs(got - ref).max() <= 32 * EPS32 * sf


@pytest.mark.parametrize("name", DPK_EC_GOLDENS)
def test_dpk_ec_goldens_decode(oracle, name):
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu.core import container as ct

    blob = (GOLDEN / f"{name}.z").read_bytes()
    manifest = json.loads((GOLDEN / "manifest.json").read_text())[name]
    ref = np.asarray(dctz_tpu.decompress(blob))
    got = dz.decompress(blob, device="cpu")
    assert got.shape == (manifest["n"],) == ref.shape
    sf = ct.parse_v2(blob)[0].scaling_factor
    assert np.abs(got - ref).max() <= 32 * EPS32 * sf
    x = np.fromfile(GOLDEN / "golden_input_f64.bin", np.float64).astype(np.float32)
    assert np.abs(got - x).max() <= bound(x)


@pytest.mark.parametrize("verify", [False, True])
def test_ratio_matches_reference(oracle, verify):
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.utils.bench_data import climate_formula_np

    x = climate_formula_np(4 * TILE_N + 300)
    ref = len(dctz_tpu.compress(x, config=slice_cfg(dctz_tpu, verify=verify)))
    got = len(dz.compress(x, config=slice_cfg(dz, verify=verify), device="cpu"))
    assert abs(got / ref - 1.0) <= 0.005, (got, ref)


def test_overflow_retry_round_trip():
    """White noise at a tight bound overflows the default exception capacity;
    the full-chunk-width retry keeps the round trip within the bound."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.ops import idpack

    x = np.random.default_rng(3).standard_normal(2 * TILE_N).astype(np.float32)
    cfg = slice_cfg(dz, error_bound=1e-4)
    blob = dz.compress(x, config=cfg, device="cpu")
    y = dz.decompress(blob, device="cpu")
    assert np.abs(y - x).max() <= 1e-4 * float(x.max() - x.min())
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import container as ct

    header, streams, _q, _cb = ct.parse_v2(blob)
    exc_rows = api._dpk_host_rebuild(header, streams)[2]
    assert exc_rows.shape[1] > idpack.CAPE  # some chunk row overflowed


@pytest.mark.parametrize("kw,item", [
    (dict(container="v1"), "8"),
    (dict(mode="qt"), "7"),
    (dict(ids_codec="rans"), "8"),
    (dict(rate="auto"), "9"),
    (dict(dct_precision="high"), "9"),
    (dict(dc_delta=True), "9"),
    (dict(segment_elems=4096), "6"),
])
def test_outside_the_slice_raises(kw, item):
    import dctz_tpu_torch as dz

    x = signal(3 * 4096, 0)
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        dz.compress(x, config=slice_cfg(dz, **kw), device="cpu")


def test_compress_requires_config():
    import dctz_tpu_torch as dz

    with pytest.raises(TypeError):
        dz.compress(signal(4096, 0), device="cpu")


def test_float64_and_foreign_containers_raise():
    import dctz_tpu_torch as dz

    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        dz.compress(np.ones(4096), config=slice_cfg(dz), device="cpu")
    for name, item in [("golden_v1_ec_f64", "8"), ("golden_v2_qt_f32_dpk", "7"),
                       ("golden_v2_ec_f32_rans", "8")]:
        with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
            dz.decompress((GOLDEN / f"{name}.z").read_bytes(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        dz.decompress(b"DTZS" + bytes(64), device="cpu")
