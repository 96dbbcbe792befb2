"""The v1 container and host-coded v2 against dctz_tpu: kernels F and G's
plain versions against fused_encode_ec / fused_encode_qt in interpret mode,
the verify-repair of the fused branch, whole containers (the fused branch
at n % 1024 == 0 and the generic chain with a rem-point tail otherwise)
decoded both ways, the ratio, the 17 float32 non-DPK goldens, and the
entry-point defaults (compress(x) writes v1 EC; v2 with ids_codec="auto"
writes DPK).

Budgets, as in test_torch_qt.py: the DCT is a float32 matmul summed in
another order, so coefficients differ by up to 32 ulp of the block's max
|x/sf|; bin ids differ only where a coefficient lies within that of a bin
edge (at most 1e-4 of them); a stored QT escape differs by the coefficient
budget times eb*qt_factor/q[k] plus 4 ulp; decodes of one container agree
within 32 ulp of sf; header ac_counts agree within AC_SLACK, the escapes
that bin-edge coefficients can add or remove.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_oracle import (  # noqa: F401
    EB, EPS32, TILE_N, assert_mean_close, bound, oracle, oracle_shuffle, signal,
)
from test_torch_qt import qt_signal

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"
NON_DPK_F32_GOLDENS = [
    "golden_v2_ec_f32",
    "golden_v2_ec_f32_legacy3",
    "golden_v2_ec_f32_legacyhdrcrc",
    "golden_v2_ec_f32_legacyplc",
    "golden_v2_ec_f32_legacyv1",
    "golden_v2_ec_f32_legacyzstd",
    "golden_v2_ec_f32_rans",
    "golden_v2_ec_f32_rans_legacy1",
    "golden_v2_ec_f32_rans_legacyhdrcrc",
    "golden_v2_ec_f32_rans_legacyplc",
    "golden_v2_ec_f32_rans_legacyv1",
    "golden_v2_ec_f32_rans_legacyzstd",
    "golden_v2_qt_f32",
    "golden_v2_qt_f32_legacyhdrcrc",
    "golden_v2_qt_f32_legacyplc",
    "golden_v2_qt_f32_legacyv1",
    "golden_v2_qt_f32_legacyzstd",
]
#: v1 lengths: the fused branch; the generic chain with a rem-point tail;
#: the generic chain at chunk width 128
V1_SIZES = [3 * TILE_N, 7777, 3 * TILE_N + 128]
QTF = 10.0
AC_SLACK = 4


def _padded(x):
    return np.concatenate([x, np.zeros((-x.size) % 1024, np.float32)])


def _input(mode, n, seed):
    return qt_signal(n, seed) if mode == "qt" else signal(n, seed)


def _budget(x, sf):
    return 32 * EPS32 * np.abs(x.reshape(-1, 64) / sf).max(axis=1)[:, None]


@pytest.mark.parametrize("n", [3 * TILE_N, 5 * TILE_N - 11])
def test_fused_encode_ec_matches_reference(oracle_shuffle, n):
    from dctz_tpu.ops import fused_encode as jf
    from dctz_tpu_torch.ops import fused_encode as tf

    x = _padded(signal(n, n))
    sf = np.float32(100.0)
    ids_r, dcac_r = (np.asarray(a) for a in jf.fused_encode_ec(
        jnp.asarray(x), jnp.float32(sf), EB))
    ids_g, dcac_g = (a.numpy() for a in tf.fused_encode_ec(
        torch.from_numpy(x), torch.tensor(sf), EB))
    assert ids_g.dtype == np.uint8 and ids_g.shape == ids_r.shape
    assert np.mean(ids_g != ids_r) <= 1e-4
    assert ((ids_r == 255) & (np.arange(64) > 0)).sum() > 100
    same = ids_g == ids_r
    assert np.all((np.abs(dcac_g - dcac_r) <= _budget(x, sf))[same])


@pytest.mark.parametrize("n", [3 * TILE_N, 5 * TILE_N - 11])
def test_fused_encode_qt_matches_reference(oracle_shuffle, n):
    from dctz_tpu.ops import fused_encode as jf
    from dctz_tpu_torch.ops import fused_encode as tf

    x = _padded(qt_signal(n, n))
    sf = np.float32(100.0)
    ids_r, dcac_r, q_r = (np.asarray(a) for a in jf.fused_encode_qt(
        jnp.asarray(x), jnp.float32(sf), EB))
    ids_g, dcac_g, q_g = (a.numpy() for a in tf.fused_encode_qt(
        torch.from_numpy(x), torch.tensor(sf), EB))
    assert (q_r[1:] > 1.0).sum() > 10
    assert np.all(np.abs(q_g - q_r) <= 4 * np.spacing(np.maximum(q_g, q_r)))
    assert np.mean(ids_g != ids_r) <= 1e-4
    esc = (ids_g == 255) & (ids_r == 255) & (np.arange(64) > 0)
    assert esc.sum() > 100
    budget = _budget(x, sf)
    lim = np.where(esc, budget * np.float32(EB * QTF) / q_g
                   + 4 * np.spacing(np.abs(dcac_r)), budget)
    assert np.all((np.abs(dcac_g - dcac_r) <= lim)[ids_g == ids_r])


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_repair_fused_matches_reference(oracle_shuffle, mode):
    """The fused branch's verify-repair on the same kernel outputs, on an
    input where it forces escapes: the repaired ids within 1e-4, the same
    verified flag, the compacted rows' counts within AC_SLACK."""
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu import api as ja
    from dctz_tpu.ops import fused_encode as jf
    from dctz_tpu_torch import api as ta

    n = 2 * TILE_N
    x = qt_signal(n, 21, narrow=True)
    sf = np.float32(4.0)
    fn = jf.fused_encode_qt if mode == "qt" else jf.fused_encode_ec
    out = fn(jnp.asarray(x), jnp.float32(sf), EB)
    ids, dcac = np.array(out[0]), np.array(out[1])
    qtable = np.array(out[2]) if mode == "qt" else None
    ref = ja._repair_fused(
        jnp.asarray(x), jnp.float32(sf), jnp.asarray(ids), jnp.asarray(dcac[:, 0]),
        n, dctz_tpu.CodecConfig(mode=mode, error_bound=EB), None,
        None if qtable is None else jnp.asarray(qtable))
    ids_r, counts_r, ok_r = (np.asarray(ref[0]), np.asarray(ref[2]),
                             bool(ref[4]))
    q, ok_g = ta._repair_fused(
        torch.from_numpy(x), torch.tensor(sf), torch.from_numpy(ids),
        torch.from_numpy(dcac[:, 0].copy()), n,
        dz.CodecConfig(mode=mode, error_bound=EB),
        None if qtable is None else torch.from_numpy(qtable))
    assert (ids_r != ids).sum() > 0  # the repair fired
    assert np.mean(q.bin_ids.numpy() != ids_r) <= 1e-4
    assert bool(ok_g) == ok_r
    assert abs(int(q.ac_count.sum()) - int(counts_r.sum())) <= AC_SLACK


def _headers(blob):
    from dctz_tpu.core import container as ct

    if ct.detect_format(blob) == "v1":
        return ct.parse_v1(blob)[0]
    return ct.parse_v2(blob)[0]


def _cross_check(x, port_blob, ref_blob):
    """Headers agree (the mean within the ulp budget of
    test_torch_oracle.MEAN_ULPS: a float32 sum in another order), each
    package decodes the other's container within the bound, and the two
    decodes of the reference container agree within 32 ulp of sf."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    hp, hr = _headers(port_blob), _headers(ref_blob)
    assert (hp.num_elements, hp.mode, hp.scaling_factor) == (
        hr.num_elements, hr.mode, hr.scaling_factor)
    assert_mean_close(hp, hr, x)
    assert abs(hp.ac_count - hr.ac_count) <= AC_SLACK
    assert np.abs(np.asarray(dctz_tpu.decompress(port_blob)) - x).max() <= bound(x)
    got = dz.decompress(ref_blob, device="cpu")
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.abs(got - x).max() <= bound(x)
    ref = np.asarray(dctz_tpu.decompress(ref_blob))
    assert np.abs(got - ref).max() <= 32 * EPS32 * hr.scaling_factor
    return hp, hr


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("n", V1_SIZES)
def test_v1_containers_match_reference(oracle_shuffle, n, mode, verify):
    import dctz_tpu
    import dctz_tpu_torch as dz

    x = _input(mode, n, n + verify)
    kw = dict(mode=mode, error_bound=EB, verify=verify)
    port_blob = dz.compress(x, config=dz.CodecConfig(**kw), device="cpu")
    ref_blob = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(**kw))
    assert port_blob[:4] == ref_blob[:4] == b"\x00\x00\x00\x00"  # v1 float tag
    _cross_check(x, port_blob, ref_blob)
    assert abs(len(port_blob) / len(ref_blob) - 1.0) <= 0.005


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("ids4", [True, False])
@pytest.mark.parametrize("codec", ["deflate", "rans"])
def test_host_coded_v2_matches_reference(oracle_shuffle, codec, ids4, mode):
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import native

    if codec == "rans" and not native.available():
        pytest.skip("the native rANS coder is not built here")
    n = 3 * TILE_N + 128
    x = _input(mode, n, 5 + ids4)
    kw = dict(mode=mode, error_bound=EB, verify=True, container="v2",
              ids_codec=codec, ids4=ids4, segment_elems=0)
    port_blob = dz.compress(x, config=dz.CodecConfig(**kw), device="cpu")
    ref_blob = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(**kw))
    hp, hr = _cross_check(x, port_blob, ref_blob)
    assert not hp.dpk and (hp.ids4, hp.rans) == (hr.ids4, hr.rans) == (
        ids4, ids4 and codec == "rans")
    assert abs(len(port_blob) / len(ref_blob) - 1.0) <= 0.005


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_v1_ratio_matches_reference(oracle_shuffle, mode):
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.utils.bench_data import climate_formula_np

    x = climate_formula_np(4 * TILE_N + 300)
    ref = len(dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(mode=mode, verify=True)))
    got = len(dz.compress(x, config=dz.CodecConfig(mode=mode, verify=True),
                          device="cpu"))
    assert abs(got / ref - 1.0) <= 0.005, (got, ref)


@pytest.mark.parametrize("name", NON_DPK_F32_GOLDENS)
def test_non_dpk_goldens_decode(oracle_shuffle, name):
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu.core import container as ct

    blob = (GOLDEN / f"{name}.z").read_bytes()
    manifest = json.loads((GOLDEN / "manifest.json").read_text())[name]
    header = ct.parse_v2(blob)[0]
    assert not header.dpk and header.dtype == np.float32
    ref = np.asarray(dctz_tpu.decompress(blob))
    got = dz.decompress(blob, device="cpu")
    assert got.shape == (manifest["n"],) == ref.shape
    assert np.abs(got - ref).max() <= 32 * EPS32 * header.scaling_factor
    x = np.fromfile(GOLDEN / "golden_input_f64.bin", np.float64).astype(np.float32)
    assert np.abs(got - x).max() <= bound(x)


def test_compress_defaults_to_v1_ec():
    """dz.compress(x) with no config writes what dctz_tpu.compress(x)
    writes: a v1 EC container at eb 1e-3; the positional error bound and
    mode select the config as there."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import container as ct

    x = signal(7777, 9)
    blob = dz.compress(x, device="cpu")
    assert ct.detect_format(blob) == "v1"
    header = ct.parse_v1(blob)[0]
    assert (header.mode, header.error_bound, header.num_elements) == ("ec", 1e-3, 7777)
    assert blob == dz.compress(x, config=dz.CodecConfig(), device="cpu")
    qt = ct.parse_v1(dz.compress(x, 1e-2, "qt", device="cpu"))[0]
    assert (qt.mode, qt.error_bound) == ("qt", 1e-2)
    assert dz.evaluate(x, dz.decompress(blob, device="cpu"), 1e-3)["bound_satisfied"]


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_v2_auto_ids_codec_writes_dpk(mode):
    """CodecConfig(container="v2") leaves ids_codec at "auto", which the
    port resolves to the device coder, as dctz_tpu does on its TPU: the
    same container as ids_codec="device"."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import container as ct

    x = _input(mode, 2 * TILE_N + 5, 3)
    auto = dz.compress(x, config=dz.CodecConfig(mode=mode, container="v2"),
                       device="cpu")
    dev = dz.compress(x, config=dz.CodecConfig(mode=mode, container="v2",
                                               ids_codec="device"), device="cpu")
    assert auto == dev and ct.parse_v2(auto)[0].dpk


def test_v1_geometry_upgrades_to_v2():
    """v1 cannot record a bin count: it warns and writes v2 (host-coded, the
    ids codec "auto" of a v1 configuration), which records it and, with
    verify on, decodes within the bound (tests/test_torch_geometry.py holds
    such containers to the reference)."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import container as ct

    x = signal(4096, 0)
    with pytest.warns(UserWarning, match="writing v2 instead"):
        blob = dz.compress(x, config=dz.CodecConfig(nbins=127, verify=True),
                           device="cpu")
    assert ct.detect_format(blob) == "v2"
    assert ct.parse_v2(blob)[0].nbins == 127
    assert np.abs(dz.decompress(blob, device="cpu") - x).max() <= bound(x)
