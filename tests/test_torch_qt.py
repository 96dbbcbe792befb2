"""QT mode of the port against dctz_tpu: kernel E's plain version against
fused_encode.qtable_qmax, the QT bins and repair given the same
coefficients, the whole QT encode against
fused_encode_pipeline_dpk_qt_v2, the QT decode against dpk_fuse.decode_fused,
and QT containers decoded both ways, the QT DPK goldens included.

Budgets (the DCT and IDCT are float32 matmuls summed in another order, so
coefficients differ by up to 32 ulp of the block's max |x/sf|; everything
downstream of them is the same float32 arithmetic):
  qtable: within 4 ulp of the reference's;
  bin ids: at most 1e-4 of them differ;
  stored QT escapes ((c/q)*eb*qtf + side): within the coefficient budget
    times eb*qtf/q[k], plus 4 ulp of the stored value;
  decodes: within 32 ulp of sf of the reference's decode.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_oracle import (  # noqa: F401
    EB, EPS32, TILE_N, assert_mean_close, bound, combine_planes, oracle, signal,
    slice_cfg,
)

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"
QT_DPK_GOLDENS = [
    "golden_v2_qt_f32_dpk",
    "golden_v2_qt_f32_dpk_legacyhdrcrc",
    "golden_v2_qt_f32_dpk_legacyplc",
    "golden_v2_qt_f32_dpk_legacyzstd",
]
SIZES = [2 * TILE_N, 5 * TILE_N - 11]
QTF = 10.0  # qt_factor at 255 bins


def qt_signal(n: int, seed: int, narrow: bool = False) -> np.ndarray:
    """signal() with every 977th sample x30 (tests/test_stream.py's
    recipe), so that the qtable has entries > 1. narrow: noise in a narrow
    range off zero, where verify-repair has work in many blocks at sf = 4,
    with an alternating +-1 pattern on every 7th block, whose high
    frequencies escape without widening the range."""
    if not narrow:
        x = signal(n, seed)
        x[::977] *= np.float32(30.0)
        return x
    rng = np.random.default_rng(seed)
    alt = np.where(np.arange(n) // 64 % 7 == 3, (-1.0) ** np.arange(n), 0.0)
    return (np.float32(11.0) + rng.standard_normal(n).astype(np.float32)
            * np.float32(0.5) + alt.astype(np.float32)).astype(np.float32)


def _padded(x):
    n = x.size
    return np.concatenate([x, np.zeros((-n) % 1024, np.float32)])


def _ulps(a, b):
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


@pytest.mark.parametrize("n", SIZES)
def test_qtable_qmax_matches_reference(oracle, n):
    from dctz_tpu.ops import fused_encode as jf
    from dctz_tpu_torch.ops import fused_encode as tf

    x = _padded(qt_signal(n, n))
    sf = np.float32(100.0)
    ref = np.asarray(jf.qtable_qmax(jnp.asarray(x), jnp.float32(sf), EB))
    got = tf.qtable_qmax(torch.from_numpy(x), torch.tensor(sf), EB).numpy()
    assert got.dtype == np.float32 and got.shape == (64,)
    assert (ref[1:] > 1.0).sum() > 10  # the table is not all clamped
    assert _ulps(got, ref).max() <= 4


def test_qt_bins_and_repair_byte_equal_given_ref_coeffs():
    """Given the reference's coefficients and qtable, the QT bins, the
    repair's forced escapes, the verified flag and the stored values are
    byte-equal to dctz_tpu's quantize.encode + repair.verify_repair."""
    import jax

    from dctz_tpu.config import CodecConfig as JCfg
    from dctz_tpu.core import quantize as jq
    from dctz_tpu.core import transform as jt
    from dctz_tpu.ops import repair as jr
    from dctz_tpu_torch.config import CodecConfig as TCfg
    from dctz_tpu_torch.core import quantize as tq
    from dctz_tpu_torch.ops import repair as tr

    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        n = 2 * TILE_N
        x = qt_signal(n, 12, narrow=True)
        sf = np.float32(4.0)
        coeffs = np.asarray(jt.block_dct_flat(jnp.asarray(x) / jnp.float32(sf), 64))
        tol = np.float32((x.max() - x.min()) * np.float32(EB) * np.float32(0.99))
        jcfg = JCfg(mode="qt", error_bound=EB)
        q = jq.encode(jnp.asarray(coeffs), n, jcfg, compaction="global")
        qtable = np.asarray(q.qtable)
        ids_j, dense_j, ok_j = jr.verify_repair(
            jnp.asarray(x), jnp.asarray(coeffs), jnp.float32(sf), q.bin_ids,
            q.dc, q.qtable, n, n, jcfg, jnp.float32(tol),
        )
        tcfg = TCfg(mode="qt", error_bound=EB)
        c_t = torch.from_numpy(coeffs.copy())
        q_t = torch.from_numpy(qtable.copy())
        ids0 = tq.encode_ids_qt(c_t, n, tcfg, q_t)
        assert np.array_equal(ids0.numpy().astype(np.uint8), np.asarray(q.bin_ids))
        ids_t, ok_t = tr.verify_repair(
            torch.from_numpy(x), c_t, torch.tensor(sf), ids0, c_t[:, 0], n, n,
            tcfg, torch.tensor(tol), q_t,
        )
        assert (np.asarray(ids_j) != np.asarray(q.bin_ids)).sum() > 0  # fired
        assert np.array_equal(ids_t.numpy().astype(np.uint8), np.asarray(ids_j))
        assert bool(ok_t) == bool(ok_j)
        acm = tq.ac_mask(n // 64, 64, n, "cpu")
        dense_t = tr.stored_dense(c_t, ids_t, acm, tcfg, q_t)
        assert dense_t.numpy().tobytes() == np.asarray(dense_j).tobytes()
    finally:
        jax.config.update("jax_enable_x64", old)


def _stream_grid(out, nblk, n_stream, cw):
    """(ids, stored values at escapes) from a set of encode streams (the
    port's plain unpack, which test_torch_dpk_decode holds byte-equal to
    the reference)."""
    from dctz_tpu_torch.ops import dpk_fuse as td

    width, packed, exc, _ec, ac, _acc, _dc = [torch.as_tensor(np.array(o))
                                             for o in out[:7]]
    ids, acv = td.dpk_unpack_expand(width, packed, exc, ac, nblk, n_stream, cw)
    return ids.numpy(), acv.numpy()


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_qt_pipeline_matches_reference(oracle, verify, n):
    from dctz_tpu.core.quantize import chunk_width
    from dctz_tpu.ops import fused_encode as jf
    from dctz_tpu_torch.ops import fused_encode as tf

    x = _padded(qt_signal(n, n + verify, narrow=verify))
    n_pad = x.size
    sf = np.float32(4.0 if verify else 100.0)
    ref = jf.fused_encode_pipeline_dpk_qt_v2(
        jnp.asarray(x), jnp.float32(sf), EB, 128, n, verify
    )
    got = tf.fused_encode_pipeline_dpk_qt_v2(
        torch.from_numpy(x), torch.tensor(sf), EB, 128, n, verify
    )
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]
    nblk = n_pad // 64
    last = -(-n // 64) - 1
    # qtable: slots >= 1 within 4 ulp; slot 0 is the last REAL block's DC
    assert _ulps(got[9][1:], ref[9][1:]).max() <= 4
    assert got[9][0] == got[6][last]
    budget = 32 * EPS32 * np.abs(x.reshape(-1, 64) / sf).max(axis=1)
    assert abs(got[9][0] - ref[6][last]) <= budget[last]
    assert bool(ref[7]) == bool(got[7]) and bool(ref[8]) == bool(got[8])
    cw = chunk_width(n_pad, 64)
    ids_r, acv_r = _stream_grid(ref, nblk, n_pad, cw)
    ids_g, acv_g = _stream_grid(got, nblk, n_pad, cw)
    assert np.mean(ids_r != ids_g) <= 1e-4
    assert np.all(np.abs(ref[6] - got[6]) <= budget)  # the DC stream
    both = (ids_r == 255) & (ids_g == 255) & (np.arange(64) >= 1)
    assert both.sum() > 100
    q = got[9][None, :]
    lim = (budget[:, None] * np.float32(EB * QTF) / q
           + 4 * np.spacing(np.abs(acv_r)))
    assert np.all(np.abs(acv_r - acv_g)[both] <= lim[both])
    if verify:  # repair really changed ids on this input
        plain = tf.fused_encode_pipeline_dpk_qt_v2(
            torch.from_numpy(x), torch.tensor(sf), EB, 128, n, False
        )
        assert not np.array_equal(_stream_grid(plain, nblk, n_pad, cw)[0], ids_g)


def _qt_container(pkg, x, **kw):
    return pkg.compress(x, config=slice_cfg(pkg, mode="qt", **kw),
                        **({"device": "cpu"} if pkg.__name__ == "dctz_tpu_torch" else {}))


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_qt_round_trip_holds_bound(n, verify):
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import container as ct

    x = qt_signal(n, n + 3)
    blob = _qt_container(dz, x, verify=verify)
    header, _s, qtable, _cb = ct.parse_v2(blob)
    assert header.mode == "qt" and header.dpk and (qtable[1:] > 1.0).any()
    y = dz.decompress(blob, device="cpu")
    assert y.dtype == np.float32 and y.shape == x.shape
    assert dz.evaluate(x, y, EB)["bound_satisfied"]


@pytest.mark.parametrize("n", SIZES)
def test_qt_containers_decode_both_ways(oracle, n):
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu.core import container as ct

    x = qt_signal(n, n + 4)
    port_blob = _qt_container(dz, x)
    assert np.abs(np.asarray(dctz_tpu.decompress(port_blob)) - x).max() <= bound(x)
    ref_blob = _qt_container(dctz_tpu, x)
    ref = np.asarray(dctz_tpu.decompress(ref_blob))
    got = dz.decompress(ref_blob, device="cpu")
    assert np.abs(got - x).max() <= bound(x)
    sf = ct.parse_v2(ref_blob)[0].scaling_factor
    assert np.abs(got - ref).max() <= 32 * EPS32 * sf
    assert abs(len(port_blob) / len(ref_blob) - 1.0) <= 0.005
    assert_mean_close(ct.parse_v2(port_blob)[0], ct.parse_v2(ref_blob)[0], x)


def test_qt_decode_fused_matches(oracle):
    """The port's plain QT decode (C then D) within 32 ulp of sf of the
    Pallas decode_fused (its QT branch) on a reference container."""
    import dctz_tpu
    from dctz_tpu import api
    from dctz_tpu.core import container as ct
    from dctz_tpu.ops import dpk_fuse as jd
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.ops import dpk_fuse as td

    n = 3 * TILE_N
    blob = _qt_container(dctz_tpu, qt_signal(n, 8))
    header, streams, qtable, _cb = ct.parse_v2(blob)
    (width, rows, exc, dc, ac), (n_stream, _tb, cw, cfg, _lay) = api._dpk_decode_prep(
        header, streams
    )
    dc, ac = combine_planes(dc), combine_planes(ac)
    sf = np.float32(header.scaling_factor)
    ref = np.asarray(jd.decode_fused(
        *(jnp.asarray(a) for a in (width, rows, exc, ac, dc)), jnp.float32(sf),
        cfg, cw, jnp.asarray(qtable),
    ))[:n_stream]
    got = td.decode_fused(
        *(torch.from_numpy(np.array(a)) for a in (width, rows, exc, ac, dc)),
        torch.tensor(sf), CodecConfig(mode="qt", error_bound=cfg.error_bound),
        cw, n_stream, torch.from_numpy(qtable.astype(np.float32)),
    ).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 32 * EPS32 * sf


@pytest.mark.parametrize("name", QT_DPK_GOLDENS)
def test_qt_dpk_goldens_decode(oracle, name):
    """The committed QT DPK containers (7777 samples, a partial last block)
    decode within the bound and within 32 ulp of sf of dctz_tpu's decode."""
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu.core import container as ct

    blob = (GOLDEN / f"{name}.z").read_bytes()
    manifest = json.loads((GOLDEN / "manifest.json").read_text())[name]
    header, _s, qtable, _cb = ct.parse_v2(blob)
    assert header.mode == "qt" and qtable is not None
    ref = np.asarray(dctz_tpu.decompress(blob))
    got = dz.decompress(blob, device="cpu")
    assert got.shape == (manifest["n"],) == ref.shape
    assert np.abs(got - ref).max() <= 32 * EPS32 * header.scaling_factor
    x = np.fromfile(GOLDEN / "golden_input_f64.bin", np.float64).astype(np.float32)
    assert np.abs(got - x).max() <= bound(x)
