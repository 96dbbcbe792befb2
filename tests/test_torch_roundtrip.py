"""The DPK EC path end to end on the CPU: round trips, containers decoded
both ways between the port and dctz_tpu, the DPK EC goldens, the ratio, a
DPK container of 64-block tiles, and the configurations that were ported last
(host-coded DTZS frames, dc_delta and the codec options of ROADMAP item
9; QT mode and DTZS streams:
test_torch_qt.py, test_torch_stream.py, test_torch_stream_generic.py; v1
and host-coded v2: test_torch_v1.py; dc_delta: test_torch_dc_delta.py)."""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax

from test_torch_oracle import (  # noqa: F401
    EPS32, TILE_N, assert_mean_close, bound, oracle, oracle_shuffle, ref_arithmetic,
    signal, slice_cfg,
)

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

    from dctz_tpu_torch.core import container as ct

    x = climate_formula_np(4 * TILE_N + 300)
    ref_blob = dctz_tpu.compress(x, config=slice_cfg(dctz_tpu, verify=verify))
    port_blob = dz.compress(x, config=slice_cfg(dz, verify=verify), device="cpu")
    ref, got = len(ref_blob), len(port_blob)
    assert abs(got / ref - 1.0) <= 0.005, (got, ref)
    # the header's mean: a float32 sum in another order
    assert_mean_close(ct.parse_v2(port_blob)[0], ct.parse_v2(ref_blob)[0], x)


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


@pytest.mark.parametrize("n", [3 * 4096 + 5, 5 * TILE_N - 11])
def test_dpk_tile_64_decodes_as_reference(oracle, ref_arithmetic, n):
    """A DPK container whose tiles are 64 blocks (no writer of either
    package makes one by default): the reference's XLA chain with its
    idpack.B_DEFAULT at 64, so its _dpk_sections write tile 64 in the meta
    section. The port decodes it through the torch ops that take any tile
    (idpack.unpack_ids, qz.expand_ac; kernel D's plain version), within the
    bound and equal to the reference's decode."""
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu.ops import idpack as ji
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import container as ct

    x = signal(n, 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ji, "B_DEFAULT", 64)
        blob = dctz_tpu.compress(x, config=slice_cfg(dctz_tpu))
    header, streams, _q, _cb = ct.parse_v2(blob)
    assert api._dpk_meta(header, streams)[1] == 64
    y = dz.decompress(blob, device="cpu")
    assert y.dtype == np.float32 and y.shape == x.shape
    assert np.abs(y - x).max() <= bound(x)
    assert np.array_equal(y, np.asarray(dctz_tpu.decompress(blob)))


#: the configurations that raised ROADMAP item 8 (host-coded DTZS frames)
#: or item 9 (dc_delta; rate="auto", brsf != 1, truncate=False and a
#: non-default block size or bin count) until they were ported, and more of
#: their kind (tests/test_torch_rate.py, test_torch_geometry.py and
#: test_torch_truncate.py hold the last five's containers byte for byte)
PORTED = {
    "v1_dtzs": dict(container="v1", segment_elems=4096),
    "v1_qt_dtzs": dict(container="v1", mode="qt", segment_elems=4096),
    "qt_deflate_dtzs": dict(mode="qt", ids_codec="deflate", segment_elems=4096),
    "rans_dtzs": dict(ids_codec="rans", segment_elems=4096),
    "deflate_dtzs": dict(segment_elems=4096, ids_codec="deflate"),
    "dc_delta": dict(dc_delta=True),
    "dc_delta_dtzs": dict(dc_delta=True, segment_elems=4096),
    "dc_delta_deflate": dict(dc_delta=True, ids_codec="deflate"),
    "dc_delta_v1_dtzs": dict(dc_delta=True, container="v1", segment_elems=4096),
    "rate_auto": dict(rate="auto"),
    "brsf": dict(brsf=2.0),
    "truncate_off": dict(truncate=False),
    "nbins": dict(nbins=127),
    "block_size": dict(block_size=32),
}


@pytest.mark.parametrize("kw", list(PORTED.values()), ids=list(PORTED))
def test_formerly_unported_configs_round_trip(oracle_shuffle, kw):
    """Each compresses (a DTZS stream where segment_elems asks for one),
    and each package decodes the other's output within the bound."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    x = signal(3 * 4096, 0)
    port = dz.compress(x, config=slice_cfg(dz, **kw), device="cpu")
    ref = dctz_tpu.compress(x, config=slice_cfg(dctz_tpu, **kw))
    assert (port[:4] == b"DTZS") == (ref[:4] == b"DTZS") == ("segment_elems" in kw)
    for y in (dz.decompress(port, device="cpu"), np.asarray(dctz_tpu.decompress(port)),
              dz.decompress(ref, device="cpu")):
        assert y.shape == x.shape and np.abs(y - x).max() <= bound(x)


def test_compress_requires_config():
    """compress no longer requires a config: without one it writes the
    JAX package's default, a v1 EC container; what it still requires is a
    keyword config (a positional one lands in the error-bound slot, as in
    dctz_tpu) and a float32 array."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import container as ct

    x = signal(4096, 0)
    assert ct.detect_format(dz.compress(x, device="cpu")) == "v1"
    with pytest.raises(TypeError):
        dz.compress(x, slice_cfg(dz), device="cpu")
    with pytest.raises(TypeError):
        dz.compress(x.astype(np.int32), device="cpu")


def test_float64_and_foreign_containers_raise():
    """Float64 input and float64 containers are ported (tests/test_torch_f64.py
    holds them to the reference), and so are the containers with full-width
    streams (truncate=False: tests/test_torch_truncate.py), which decode
    within the bound."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    ones = np.ones(4096)
    blob = dz.compress(ones, config=slice_cfg(dz), device="cpu")
    got = dz.decompress(blob, device="cpu")
    assert got.dtype == np.float64 and np.array_equal(got, ones)
    golden = dz.decompress((GOLDEN / "golden_v1_ec_f64.z").read_bytes(),
                           device="cpu")
    x64 = np.fromfile(GOLDEN / "golden_input_f64.bin", np.float64)
    assert golden.dtype == np.float64 and np.abs(golden - x64).max() <= bound(x64)
    with jax.enable_x64(True):  # other tests of this module turn it off
        wide = dctz_tpu.compress(x64, config=dctz_tpu.CodecConfig(truncate=False))
    got = dz.decompress(wide, device="cpu")
    assert got.dtype == np.float64 and np.abs(got - x64).max() <= bound(x64)
    # the float32 non-DPK goldens decode (all 28 goldens: test_torch_v1.py
    # and test_torch_f64.py)
    x = np.fromfile(GOLDEN / "golden_input_f64.bin", np.float64).astype(np.float32)
    for name in ("golden_v2_qt_f32", "golden_v2_ec_f32_rans"):
        got = dz.decompress((GOLDEN / f"{name}.z").read_bytes(), device="cpu")
        assert got.shape == x.shape and np.abs(got - x).max() <= bound(x)
    # a DTZS stream whose frame is a v2 container without the DPK id stream
    # (a host-coded frame) decodes as that container does
    import struct

    frame = (GOLDEN / "golden_v2_ec_f32.z").read_bytes()
    raw = (b"DTZS" + struct.pack("<HHQ", 1, 0, 7777)
           + struct.pack("<Q", len(frame)) + frame + struct.pack("<Q", 0))
    got = dz.decompress(raw, device="cpu")
    assert got.tobytes() == dz.decompress(frame, device="cpu").tobytes()
    assert np.abs(got - x).max() <= bound(x)
