"""Float64 in the port against dctz_tpu as tests/conftest.py leaves it: x64
on and no fused force, its float64 parity configuration (the CPU policy of
dctz_tpu/api.py:1526-1600: float64 at full width on the XLA chain).

Rules (tests/test_parity_native.py:30-48): an EC container equals the
reference's after util.canonical (the mean zeroed: it is a sum in another
order); a QT container has the same sections and header minus the mean,
and its float64 qtable within rtol 1e-15 (its maxima are of coefficients
that differ by an ulp between two float64 transforms). A DTZS stream holds
its frames to the same rules. Decodes hold the bound, return float64, and
agree with the reference's within 8 eps64 * max|y| (the port's float64
inverse transform sums in another order).

internal_dtype="float32" runs the float32 routes, so those cases are held
against the `oracle` fixture (x64 off, the fused dispatch forced), as the
float32 tests are. The fixture is module-scoped and leaves x64 off until
the module ends, so those tests come last in this file.
"""

import dataclasses
import io
import json
import pathlib

import numpy as np
import pytest
import torch

import jax

from test_torch_oracle import TILE_N, oracle  # noqa: F401
from test_torch_stream import _frames
from test_torch_v1 import AC_SLACK
from util import canonical

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"
EB = 1e-3
EPS64 = float(np.finfo(np.float64).eps)
#: the three-frame layout of tests/test_torch_stream_generic.py: the last
#: frame ends mid-block
N = 4 * TILE_N + 1025
SEG = 2 * TILE_N
PARITY_SIZES = [64 * 512, 64 * 512 + 31, 777]


def signal64(n: int, seed: int) -> np.ndarray:
    """A float64 climate-shaped signal with noise and rare x30 spikes
    (escapes, so that the QT qtable has entries > 1), computed in doubles."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    x = np.sin(t * 0.003) * 30.0 + rng.standard_normal(n) * 0.7
    x[::977] *= 30.0
    return x


def bound(x: np.ndarray) -> float:
    return EB * float(x.max() - x.min())


def _parse(blob):
    from dctz_tpu_torch.core import container as ct

    if ct.detect_format(blob) == "v1":
        header, *streams, qtable = ct.parse_v1(blob)
        return header, tuple(streams), qtable
    header, streams, qtable, _cb = ct.parse_v2(blob)
    return header, streams, qtable


def assert_same_container(port: bytes, ref: bytes) -> None:
    """The module docstring's rules, frame by frame for a DTZS stream."""
    if port[:4] == b"DTZS":
        pf, rf = _frames(port), _frames(ref)
        assert len(pf) == len(rf)
        for a, b in zip(pf, rf):
            assert_same_container(a, b)
        return
    hp, sp, qp = _parse(port)
    hr, sr, qr = _parse(ref)
    if qr is None:
        assert qp is None and canonical(port) == canonical(ref)
        return
    assert sp == sr
    assert (dataclasses.replace(hp, mean=0.0) == dataclasses.replace(hr, mean=0.0))
    assert qp.dtype == qr.dtype == hr.dtype
    np.testing.assert_allclose(qp, qr, rtol=1e-15, atol=0)


def assert_decodes(x, port: bytes, ref: bytes) -> None:
    """Each package decodes each container within the bound, to float64;
    the two decodes of the reference's container agree within 8 eps64 *
    max|y|."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    got = dz.decompress(ref, device="cpu")
    want = np.asarray(dctz_tpu.decompress(ref))
    assert got.dtype == want.dtype == np.float64 and got.shape == x.shape
    assert np.abs(got - want).max() <= 8 * EPS64 * np.abs(want).max()
    for y in (got, dz.decompress(port, device="cpu"),
              np.asarray(dctz_tpu.decompress(port))):
        assert y.dtype == np.float64 and np.abs(y - x).max() <= bound(x)


# ---------------------------------------------------------------------------
# the building blocks, bit for bit on the same coefficients
# ---------------------------------------------------------------------------


def _coeffs64(n: int, seed: int):
    """(x, sf, dctz_tpu's float64 coefficients (nblk, 64), a partial last
    block through the rem-point basis)."""
    from dctz_tpu.api import _pad_coeffs
    from dctz_tpu.core import transform as jt

    import jax.numpy as jnp

    x = signal64(n, seed)
    sf = 0.1
    return x, sf, np.asarray(_pad_coeffs(*jt.forward(jnp.asarray(x / sf), 64), 64))


@pytest.mark.parametrize("n", [64, 33, 7])
def test_basis_and_transform_are_the_reference_doubles(n):
    """The float64 basis unrounded, byte for byte (a rem-point basis for a
    partial block too), and the blockwise transform within 64 eps64 * max|x|
    of dctz_tpu's, and its inverse of x (64-term products summed in another
    order: the a-priori bound of a 64-term dot product)."""
    import jax.numpy as jnp

    from dctz_tpu.core import transform as jt
    from dctz_tpu_torch.core import transform as tt

    got = tt.dct2_basis(n, "cpu", torch.float64).numpy()
    assert got.tobytes() == np.asarray(jt.dct2_basis(n, jnp.float64)).tobytes()
    x = signal64(5 * 64 + 17, n)
    rm, rt = (np.asarray(a) for a in jt.forward(jnp.asarray(x), 64))
    gm, gt = tt.forward(torch.from_numpy(x), 64)
    lim = 64 * EPS64 * np.abs(x).max()
    assert gm.dtype == torch.float64 and gt.shape == (17,)
    assert np.abs(gm.numpy() - rm).max() <= lim
    assert np.abs(gt.numpy() - rt).max() <= lim
    y = tt.inverse(gm, gt).numpy()
    assert np.abs(y - x).max() <= lim


@pytest.mark.parametrize("eb", [1e-3, 1e-5, 0.37])
def test_geometry_is_the_reference_doubles(eb):
    from dctz_tpu.config import CodecConfig as JCfg
    from dctz_tpu.core import quantize as jq
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.core import quantize as qz

    ref = jq._geometry(JCfg(error_bound=eb), np.dtype(np.float64))
    got = qz._geometry(CodecConfig(error_bound=eb), torch.float64)
    assert [float(r) for r in ref] == list(got)
    assert got != qz._geometry(CodecConfig(error_bound=eb))  # float32's


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_bins_and_renorm_match_reference(mode):
    """quantize at float64 against dctz_tpu.core.quantize.encode: the ids,
    the DC, the stored values (float32) and the float64 qtable, bit for
    bit, given the same coefficients."""
    import jax.numpy as jnp

    from dctz_tpu.config import CodecConfig as JCfg
    from dctz_tpu.core import quantize as jq
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.core import constants as C
    from dctz_tpu_torch.core import quantize as qz

    n = 8 * 1024 - 3
    _x, _sf, coeffs = _coeffs64(n, 3)
    q = jq.encode(jnp.asarray(coeffs), n, JCfg(mode=mode), compaction="global")
    ids, dc, vals, qtable = qz.quantize(torch.from_numpy(coeffs.copy()), n,
                                        CodecConfig(mode=mode))
    assert np.array_equal(ids.numpy().astype(np.uint8), np.asarray(q.bin_ids))
    assert dc.dtype == torch.float32
    assert np.array_equal(dc.numpy(), np.asarray(q.dc))
    esc = (ids.numpy() == C.ESCAPE) & qz.ac_mask(*ids.shape, n, "cpu").numpy()
    stored = vals.to(torch.float32).numpy()[esc]
    assert stored.size > 50
    assert np.array_equal(stored, np.asarray(q.ac_buf)[: int(q.ac_count)])
    if mode == "qt":
        assert qtable.dtype == torch.float64 and (qtable[1:] > 1).sum() > 5
        assert np.array_equal(qtable.numpy(), np.asarray(q.qtable))


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_verify_repair_matches_reference(mode):
    """verify_repair at float64 against dctz_tpu.ops.repair on the same
    coefficients: the repaired ids and the verified flag, bit for bit, on an
    input where the repair forces escapes, and the float64 decode of the
    stored values against dctz_tpu's quantize.decode."""
    import jax.numpy as jnp

    from dctz_tpu.config import CodecConfig as JCfg
    from dctz_tpu.core import quantize as jq
    from dctz_tpu.ops import repair as jr
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.ops import repair

    n = 8 * 1024
    rng = np.random.default_rng(5)
    # narrow noise off zero: the bins' errors add up past the tolerance in
    # many blocks (tests/test_torch_qt.py's recipe, in doubles)
    x = 11.0 + rng.standard_normal(n) * 0.5
    x += np.where(np.arange(n) // 64 % 7 == 3, (-1.0) ** np.arange(n), 0.0)
    sf = 4.0
    from dctz_tpu.core import transform as jt

    coeffs = np.asarray(jt.block_dct_flat(jnp.asarray(x / sf), 64))
    tol = (x.max() - x.min()) * EB * 0.99
    jcfg = JCfg(mode=mode)
    q = jq.encode(jnp.asarray(coeffs), n, jcfg, compaction="global")
    ids_j, dense_j, ok_j = jr.verify_repair(
        jnp.asarray(x), jnp.asarray(coeffs), jnp.float64(sf), q.bin_ids, q.dc,
        q.qtable, n, n, jcfg, jnp.float64(tol))
    cfg = CodecConfig(mode=mode)
    c_t = torch.from_numpy(coeffs.copy())
    ids0, dc, _vals, qtable = qz.quantize(c_t, n, cfg)
    ids_t, ok_t = repair.verify_repair(
        torch.from_numpy(x), c_t, torch.tensor(sf, dtype=torch.float64), ids0,
        dc, n, n, cfg, torch.tensor(tol, dtype=torch.float64), qtable)
    assert not np.array_equal(ids0.numpy(), ids_t.numpy())  # it repaired
    assert np.array_equal(ids_t.numpy().astype(np.uint8), np.asarray(ids_j))
    assert bool(ok_t) == bool(ok_j)
    acm = qz.ac_mask(*ids_t.shape, n, "cpu")
    dense = repair.stored_dense(c_t, ids_t, acm, cfg, qtable).to(torch.float32)
    assert np.array_equal(dense.numpy()[acm.numpy()],
                          np.asarray(dense_j)[acm.numpy()])
    ref = np.asarray(jq.decode(ids_j, q.dc, dense_j, q.qtable, n, jcfg,
                               jnp.float64, "dense"))
    got = qz.decode_dense(ids_t, dc, dense, n, cfg, qtable, torch.float64)
    assert got.dtype == torch.float64 and np.array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# the v1 float64 parity path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("verify", [False, True], ids=["noverify", "verify"])
@pytest.mark.parametrize("n", PARITY_SIZES)
@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_v1_matches_reference(mode, n, verify):
    """tests/test_parity_native.py's inputs, both packages at float64."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    x = np.random.default_rng(n).standard_normal(n) * 250
    kw = dict(mode=mode, error_bound=EB, verify=verify)
    port = dz.compress(x, config=dz.CodecConfig(**kw), device="cpu")
    ref = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(**kw))
    assert port[:4] != b"DTZS" and _parse(port)[0].dtype == np.float64
    assert_same_container(port, ref)
    assert_decodes(x, port, ref)


@pytest.mark.parametrize("n", PARITY_SIZES)
@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_v1_matches_native(mode, n):
    """The C++ codec of cpp/ (the reference's double build) writes the same
    container, where it builds here."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import native

    if not native.available():
        pytest.skip("native codec not built")
    x = np.random.default_rng(n).standard_normal(n) * 250
    assert_same_container(dz.compress(x, EB, mode, device="cpu"),
                          native.compress(x, EB, mode))


@pytest.mark.parametrize("name", ["golden_v1_ec_f64", "golden_v1_qt_f64"])
def test_f64_goldens_decode(name):
    import dctz_tpu
    import dctz_tpu_torch as dz

    meta = json.loads((GOLDEN / "manifest.json").read_text())[name]
    blob = (GOLDEN / f"{name}.z").read_bytes()
    got = dz.decompress(blob, device="cpu")
    want = np.asarray(dctz_tpu.decompress(blob))
    assert got.dtype == np.float64 and got.size == meta["n"] == 7777
    assert np.abs(got - want).max() <= 8 * EPS64 * np.abs(want).max()


@pytest.mark.parametrize("name,mode", [("golden_v1_ec_f64", "ec"),
                                       ("golden_v1_qt_f64", "qt")])
def test_f64_goldens_reencode(name, mode):
    """tests/test_golden.py's configurations on the committed input."""
    import dctz_tpu_torch as dz

    x = np.fromfile(GOLDEN / "golden_input_f64.bin", np.float64)
    port = dz.compress(x, config=dz.CodecConfig(mode=mode, container="v1"),
                       device="cpu")
    assert_same_container(port, (GOLDEN / f"{name}.z").read_bytes())


# ---------------------------------------------------------------------------
# host-coded v2, DPK v2 and DTZS at float64
# ---------------------------------------------------------------------------

FAMILIES = {
    "host_coded": dict(container="v2", ids_codec="deflate", segment_elems=0),
    "rans": dict(container="v2", ids_codec="rans", segment_elems=0),
    "dpk": dict(container="v2", ids_codec="device", segment_elems=0),
    # the device ids on float64 write host-coded frames
    "dtzs": dict(container="v2", ids_codec="device", segment_elems=SEG),
    "dtzs_v1": dict(container="v1", segment_elems=SEG),
}


def _compress_both(x, kw, tensor: bool):
    """(the port's container, dctz_tpu's) of x: numpy input, or a tensor
    and a jax array (a DTZS writer's device route)."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    import jax.numpy as jnp

    port = dz.compress(torch.from_numpy(x) if tensor else x,
                       config=dz.CodecConfig(**kw), device="cpu")
    ref = dctz_tpu.compress(jnp.asarray(x) if tensor else x,
                            config=dctz_tpu.CodecConfig(**kw))
    return port, ref


@pytest.mark.parametrize("tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_f64_containers_match_reference(family, mode, tensor):
    from dctz_tpu_torch import api, native
    from dctz_tpu_torch.core import container as ct

    if family == "rans" and not native.available():
        pytest.skip("the native rANS coder is not built here")
    x = signal64(N, 7)
    kw = dict(FAMILIES[family], mode=mode, error_bound=EB, verify=True)
    port, ref = _compress_both(x, kw, tensor)
    assert_same_container(port, ref)
    assert_decodes(x, port, ref)
    frames = _frames(port) if port[:4] == b"DTZS" else [port]
    assert len(frames) == (3 if kw["segment_elems"] else 1)
    sf = _parse(frames[0])[0].scaling_factor
    for f in frames:
        h = _parse(f)[0]
        assert h.dtype == np.float64 and h.scaling_factor == sf
        assert h.dpk == (family == "dpk") and not h.dcd
    if family == "dpk":
        header, streams, _q, _cb = ct.parse_v2(port)
        n_stream, _tb, cw = api._dpk_host_rebuild(header, streams)[5:8]
        assert (n_stream, cw) == (N, 64)  # the true length, N % 64 == 1
    if family == "dtzs":  # Huffman-only deflated ids, never rANS
        assert not any(_parse(f)[0].rans for f in frames)


@pytest.mark.parametrize("n,cw", [(777, 64), (4 * TILE_N - 5, 512),
                                  (4 * TILE_N + 192, 64)])
def test_dpk_stream_length_is_true_n(n, cw):
    """The XLA chain's DPK container pads to a block only, and takes the
    chunk width of that length: n = 777 gives 13 blocks and width 64 (kernel
    J's arm on the card), 1027 blocks width 64, 1024 blocks 512 (kernel
    B's). The stream length is n, and the container is the reference's."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import container as ct

    x = signal64(n, n)
    kw = dict(FAMILIES["dpk"], mode="ec", error_bound=EB, verify=True)
    port, ref = _compress_both(x, kw, False)
    assert_same_container(port, ref)
    assert_decodes(x, port, ref)
    header, streams, _q, _cb = ct.parse_v2(port)
    assert api._dpk_host_rebuild(header, streams)[5:8] == (n, 256, cw)


def test_f64_streams_decode_to_float64():
    """decompress_stream yields float64 frames and decompress_stream_all
    allocates float64 from the first frame."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import stream

    x = signal64(N, 9)
    blob = dz.compress(x, config=dz.CodecConfig(**FAMILIES["dtzs"]), device="cpu")
    parts = list(stream.decompress_stream(io.BytesIO(blob), device="cpu"))
    assert [p.dtype for p in parts] == [np.float64] * 3
    whole = stream.decompress_stream_all(io.BytesIO(blob), device="cpu")
    assert whole.dtype == np.float64
    assert np.array_equal(np.concatenate(parts), whole)
    assert np.abs(whole - x).max() <= bound(x)


def test_truncate_off_f64_container_raises():
    """A float64 container with full-width (8-byte) DC and AC streams, as
    dctz_tpu writes with truncate=False, decodes in the port (it raised
    until ROADMAP item 9 was ported): float64, within the bound, and within
    8 eps64 * max|y| of the reference's decode (tests/test_torch_truncate.py
    holds the port's own such containers to the reference)."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    x = signal64(4096, 1)
    for kw in (dict(container="v2", ids_codec="deflate"), dict(container="v1")):
        blob = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(truncate=False,
                                                                **kw))
        got = dz.decompress(blob, device="cpu")
        want = np.asarray(dctz_tpu.decompress(blob))
        assert got.dtype == np.float64 and np.abs(got - x).max() <= bound(x)
        assert np.abs(got - want).max() <= 8 * EPS64 * np.abs(want).max()


# ---------------------------------------------------------------------------
# internal_dtype="float32": the float32 routes (the oracle fixture turns x64
# off for the rest of the module, so these come last)
# ---------------------------------------------------------------------------

FAST = {
    "dpk": dict(container="v2", ids_codec="device", segment_elems=0),
    "host_coded": dict(container="v2", ids_codec="deflate", segment_elems=0),
    "v1": dict(container="v1"),
}


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("family", list(FAST))
def test_internal_float32_monolithic(oracle, family, mode):
    """The float32 routes on the cast array, the header declaring float64,
    held to the float32 rules of tests/test_torch_v1.py (the float32
    transforms sum in another order than the oracle's): the header equal
    but for the mean, the section sizes and ac_count within AC_SLACK, the
    ratio within 0.5%. Both decode at full width to float64 within the
    bound, both ways, and the two decodes of the oracle's container agree
    within 8 eps64 * max|y| (the same stored values, float64 arithmetic)."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    x = signal64(N, 11)
    kw = dict(FAST[family], mode=mode, error_bound=EB, verify=True,
              internal_dtype="float32")
    port = dz.compress(x, config=dz.CodecConfig(**kw), device="cpu")
    ref = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(**kw))
    hp, hr = _parse(port)[0], _parse(ref)[0]
    assert hp.dtype == hr.dtype == np.float64
    keep = dict(mean=0.0, ac_count=0, bindex_nbytes=0, dc_nbytes=0, ac_nbytes=0)
    assert dataclasses.replace(hp, **keep) == dataclasses.replace(hr, **keep)
    assert abs(hp.ac_count - hr.ac_count) <= AC_SLACK
    assert abs(len(port) / len(ref) - 1.0) <= 0.005
    got = dz.decompress(ref, device="cpu")
    with jax.enable_x64(True):  # the reference's full-width decode
        want = np.asarray(dctz_tpu.decompress(ref))
    assert np.abs(got - want).max() <= 8 * EPS64 * np.abs(want).max()
    for blob in (port, ref):
        for y in (dz.decompress(blob, device="cpu"),
                  np.asarray(dctz_tpu.decompress(blob))):
            assert y.dtype == np.float64 and np.abs(y - x).max() <= bound(x)


def test_internal_float32_segmented_declares_float32(oracle):
    """The reference casts before its stream writer
    (dctz_tpu/api.py:1836-1866), so its frames declare float32 and the
    stream decodes to float32; the port does the same."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    x = signal64(N, 12)
    kw = dict(container="v2", ids_codec="device", segment_elems=SEG,
              error_bound=EB, verify=True, internal_dtype="float32")
    port = dz.compress(x, config=dz.CodecConfig(**kw), device="cpu")
    ref = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(**kw))
    for blob in (port, ref):
        frames = _frames(blob)
        assert len(frames) == 3
        assert all(_parse(f)[0].dtype == np.float32 and _parse(f)[0].dpk
                   for f in frames)
    for y in (dz.decompress(port, device="cpu"), dz.decompress(ref, device="cpu"),
              np.asarray(dctz_tpu.decompress(port))):
        assert y.dtype == np.float32 and np.abs(y - x).max() <= bound(x)


def test_internal_float32_dc_delta_keeps_raw_dc(oracle):
    """dc_delta on a monolithic DPK container declaring float64: the port
    keeps raw DC and no dcd flag (api._dcd_on), so the container decodes
    within the bound. The reference delta-codes the DC planes on the device
    but writes no flag (dctz_tpu/api.py:456-460 against :570-579), so its
    own decode misses the bound; the port does not mirror that fault."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    x = signal64(N, 13)
    kw = dict(container="v2", ids_codec="device", segment_elems=0,
              error_bound=EB, verify=True, internal_dtype="float32",
              dc_delta=True)
    port = dz.compress(x, config=dz.CodecConfig(**kw), device="cpu")
    assert not _parse(port)[0].dcd
    plain = dz.compress(x, config=dz.CodecConfig(**dict(kw, dc_delta=False)),
                        device="cpu")
    assert canonical(port) == canonical(plain)
    for y in (dz.decompress(port, device="cpu"),
              np.asarray(dctz_tpu.decompress(port))):
        assert np.abs(y - x).max() <= bound(x)
    ref = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(**kw))
    assert not _parse(ref)[0].dcd
    assert not np.abs(np.asarray(dctz_tpu.decompress(ref)) - x).max() <= bound(x)
