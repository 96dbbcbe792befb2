"""The relaxed analysis (CodecConfig.dct_precision="high") of the port
against dctz_tpu's relaxed arm: the bfloat16 split and the three-pass
product (transform.dot_bf16x3 against dpk_fuse._dot_bf16x3), the plain
versions of the RELAXED instantiations of kernels A (EC and QT), E, F and G
against the Pallas kernels with relaxed=True in interpret mode, the L2
screen's 1024-eps budget, the fused branch's verify-repair staying at
HIGHEST, and whole containers on every route with dct_precision="high".

Budgets:
  split: hi and lo bit-equal to JAX's astype(bfloat16);
  coefficients: within RELAXED_BUDGET eps32 * max|x/sf| of the block. Both
    sides take the same bfloat16 parts, whose products are exact in
    float32, and sum the three products in the same order, so they differ
    only by the order of the float32 accumulation inside each product
    (XLA's dot over the 128-wide block-diagonal basis against torch's
    matmul), as the HIGHEST arm's coefficients do (32 ulp there too). The
    bfloat16 representation error (about 2^-16 of |x/sf|) is the same on
    both sides and is not in the budget: the HIGHEST product lies beyond it;
  bin ids: equal except where the reference coefficient lies within the
    budget of a bin edge (test_torch_cuda.near_edge), at most 1e-4 of them;
  the qtable: within the budget of the array's max|x/sf|; stored QT escapes:
    within the budget times eb*qt_factor/q[k], plus 4 ulp;
  containers: decoded both ways within the bound, their ratio within 0.1%
    of the reference's. Where the JAX package takes its XLA chain on the CPU
    (v1 with n % 1024 != 0), Precision.HIGH is a no-op there
    (tests/test_dct_precision.py), so that route is held to the bound and
    to interop only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_cuda import near_edge
from test_torch_oracle import (  # noqa: F401
    EB, EPS32, TILE_N, assert_mean_close, bound, oracle, oracle_shuffle, signal,
)
from test_torch_qt import _stream_grid, qt_signal
from test_torch_stream import _frames

torch.set_num_threads(2)

RELAXED_BUDGET = 32
QTF = 10.0
SIZES = [2 * TILE_N, 5 * TILE_N - 11]


def _padded(x):
    return np.concatenate([x, np.zeros((-x.size) % 1024, np.float32)])


def _block_budget(x, sf):
    return RELAXED_BUDGET * EPS32 * np.abs(x.reshape(-1, 64) / sf).max(axis=1)


def _ref_coef(x, sf):
    """The reference's relaxed coefficients of x / sf: dpk_fuse._dot_bf16x3
    over the 128-wide block-diagonal basis, as its kernels run it."""
    from dctz_tpu.core.transform import _blockdiag_np
    from dctz_tpu.ops import dpk_fuse as jd

    xs = jnp.asarray(x) / jnp.float32(sf)
    bdf = jnp.asarray(_blockdiag_np(64, 2, True).astype(np.float32))
    return np.array(jd._dot_bf16x3(xs.reshape(-1, 128), bdf)).reshape(-1, 64)


def _ties():
    """Values whose low 16 bits are a rounding tie (0x8000) above even and
    odd bfloat16 mantissas, both signs, and values just off a tie."""
    rng = np.random.default_rng(5)
    hi = rng.integers(0x3000, 0x4800, 4096, dtype=np.uint32) << 16
    lo = np.array([0x8000, 0x7FFF, 0x8001, 0x0000], np.uint32)[
        rng.integers(0, 4, 4096)]
    sign = rng.integers(0, 2, 4096, dtype=np.uint32) << 31
    return ((hi | lo) ^ sign).view(np.float32)


def _wide():
    """float32 values over many exponents, both signs."""
    rng = np.random.default_rng(6)
    return (rng.standard_normal(4096) * 10.0 ** rng.uniform(-20, 20, 4096)).astype(np.float32)


@pytest.mark.parametrize("kind", ["signal", "ties", "wide", "basis"])
def test_split_bit_equal_to_jax(kind):
    """hi = a rounded to bfloat16 and lo = (a - hi) rounded to bfloat16, to
    nearest even both times, bit-equal to JAX's astype (the split of
    dpk_fuse._dot_bf16x3)."""
    from dctz_tpu_torch.core import transform

    a = {"signal": lambda: signal(4096, 1) / np.float32(10.0), "ties": _ties,
         "wide": _wide,
         "basis": lambda: transform.dct2_basis(64, "cpu").numpy().reshape(-1)}[kind]()
    a = np.asarray(a, np.float32)
    hi_t, lo_t = (v.numpy() for v in transform._split_bf16(torch.from_numpy(a)))
    aj = jnp.asarray(a)
    hi_j = np.asarray(aj.astype(jnp.bfloat16).astype(jnp.float32))
    lo_j = np.asarray((aj - jnp.asarray(hi_j)).astype(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(hi_t.view(np.int32), hi_j.view(np.int32))
    assert np.array_equal(lo_t.view(np.int32), lo_j.view(np.int32))
    assert np.any(lo_t != 0)


@pytest.mark.parametrize("n", SIZES)
def test_dot_bf16x3_matches_reference(n):
    """transform.block_dct(.., "high") against dpk_fuse._dot_bf16x3 within
    the budget; the HIGHEST product lies beyond it somewhere (the twin is
    the relaxed product, not the float32 one)."""
    from dctz_tpu_torch.core import transform

    x = _padded(signal(n, n + 1))
    sf = np.float32(10.0)
    ref = _ref_coef(x, sf)
    xs = torch.from_numpy(x / sf)
    got = transform.block_dct(xs.reshape(-1, 64), "high").numpy()
    budget = _block_budget(x, sf)[:, None]
    assert np.all(np.abs(got - ref) <= budget)
    highest = transform.block_dct(xs.reshape(-1, 64)).numpy()
    assert np.any(np.abs(highest - ref) > budget)
    main, tail = transform.forward(xs[: n - 11], 64, "high")
    assert torch.equal(main, transform.block_dct(xs[: (n - 11) // 64 * 64].reshape(-1, 64),
                                                 "high"))
    assert tail.shape == ((n - 11) % 64,)


def test_precision_is_checked():
    from dctz_tpu_torch.core import transform

    with pytest.raises(ValueError, match="precision"):
        transform.block_dct(torch.zeros(2, 64), "medium")


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("n", SIZES)
def test_relaxed_encode_x_fused_matches_reference(oracle, n, mode, verify):
    """Kernel A's plain version, relaxed (EC: encode_x_fused; QT: with E's,
    the DPK QT pipeline) against the Pallas encode_x_fused with
    dct_precision="high": verify off, the ids differ only near a bin edge;
    verify on (a narrow input where the repair works), at most 1e-4 of
    them; the same verify and overflow flags; DC within the budget; QT: the
    qtable and the stored escapes within theirs."""
    from dctz_tpu.core.quantize import chunk_width
    from dctz_tpu.ops import dpk_fuse as jd
    from dctz_tpu.ops import fused_encode as jf
    from dctz_tpu.ops.repair import _SLACK
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.ops import dpk_fuse as td
    from dctz_tpu_torch.ops import fused_encode as tf

    x = qt_signal(n, n + 7, narrow=verify) if mode == "qt" else signal(n, n + 7)
    if verify and mode == "ec":
        x = (np.float32(11.0) + x * np.float32(0.02)).astype(np.float32)
    x = _padded(x)
    n_pad = x.size
    sf = np.float32(4.0 if verify and mode == "qt" else 10.0)
    cw = chunk_width(n_pad, 64)
    xt, sft = torch.from_numpy(x), torch.tensor(sf)
    if mode == "qt":
        ref = jf.fused_encode_pipeline_dpk_qt_v2(jnp.asarray(x), jnp.float32(sf), EB, 128,
                                                 n, verify, 1.0, "high")
        got = tf.fused_encode_pipeline_dpk_qt_v2(xt, sft, EB, 128, n, verify, relaxed=True)
    tol = np.float32((x[:n].max() - x[:n].min()) * np.float32(EB) * np.float32(_SLACK))
    if mode == "ec":
        ref = jd.encode_x_fused(jnp.asarray(x), jnp.float32(sf), jnp.float32(tol), n, EB,
                                128, cw, verify, dct_precision="high")
        got = td.encode_x_fused(xt, sft, torch.tensor(tol), n, EB, 128, cw, verify,
                                relaxed=True)
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]
    nblk = n_pad // 64
    ids_r, acv_r = _stream_grid(ref, nblk, n_pad, cw)
    ids_g, acv_g = _stream_grid(got, nblk, n_pad, cw)
    assert bool(ref[7]) == bool(got[7]) and bool(ref[8]) == bool(got[8])
    budget = _block_budget(x, sf)
    assert np.all(np.abs(ref[6] - got[6]) <= budget)  # DC
    cfg = CodecConfig(mode=mode, error_bound=EB)
    q = torch.from_numpy(got[9]) if mode == "qt" else None
    if mode == "qt":
        assert np.all(np.abs(got[9][1:] - ref[9][1:]) <= budget.max())
        assert (ref[9][1:] > 1.0).sum() > (0 if verify else 5)
    differ = ids_r != ids_g
    assert differ.mean() <= 1e-4
    if not verify:
        near = near_edge(torch.from_numpy(_ref_coef(x, sf)),
                         torch.from_numpy(budget[:, None]), cfg, q).numpy()
        assert not np.any(differ & ~near)
    both = (ids_r == 255) & (ids_g == 255) & (np.arange(64) >= 1)
    assert both.sum() > 0
    if verify:  # the repair escaped coefficients that the bins kept
        assert (ids_g == 255).sum() > (_stream_grid(
            [g.numpy() for g in (td.encode_x_fused(xt, sft, torch.tensor(tol), n, EB, 128,
                                                   cw, False, relaxed=True)
                                 if mode == "ec" else
                                 tf.fused_encode_pipeline_dpk_qt_v2(
                                     xt, sft, EB, 128, n, False, relaxed=True))],
            nblk, n_pad, cw)[0] == 255).sum()
    lim = budget[:, None] * np.ones((1, 64), np.float32)
    if mode == "qt":
        lim = lim * np.float32(EB * QTF) / got[9][None, :] + 4 * np.spacing(np.abs(acv_r))
    assert np.all(np.abs(acv_r - acv_g)[both] <= lim[both])


@pytest.mark.parametrize("n", SIZES)
def test_relaxed_qtable_qmax_matches_reference(oracle, n):
    """Kernel E's plain version, relaxed, against the Pallas qtable_qmax
    with dct_precision="high": within the budget of the array's max|x/sf|."""
    from dctz_tpu.ops import fused_encode as jf
    from dctz_tpu_torch.ops import fused_encode as tf

    x = _padded(qt_signal(n, n))
    sf = np.float32(100.0)
    ref = np.asarray(jf.qtable_qmax(jnp.asarray(x), jnp.float32(sf), EB, 1.0, "high"))
    got = tf.qtable_qmax(torch.from_numpy(x), torch.tensor(sf), EB, relaxed=True).numpy()
    assert (ref[1:] > 1.0).sum() > 10
    assert np.all(np.abs(got - ref) <= _block_budget(x, sf).max())


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("n", SIZES)
def test_relaxed_fused_encode_matches_reference(oracle_shuffle, mode, n):
    """Kernels F and G's plain version, relaxed, against the Pallas
    fused_encode_ec / fused_encode_qt with dct_precision="high": the ids
    differ only near a bin edge; DC and stored values within the budget
    (QT escapes: times eb*qt_factor/q[k], plus 4 ulp); the qtable within
    the budget."""
    from dctz_tpu.ops import fused_encode as jf
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.ops import fused_encode as tf

    x = _padded(qt_signal(n, n + 3) if mode == "qt" else signal(n, n + 3))
    sf = np.float32(100.0)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    q = None
    if mode == "qt":
        ids_r, dcac_r, q_r = (np.asarray(a) for a in jf.fused_encode_qt(
            xj, jnp.float32(sf), EB, 1.0, False, "high"))
        ids_g, dcac_g, q_g = (a.numpy() for a in tf.fused_encode_qt(
            xt, torch.tensor(sf), EB, relaxed=True))
        assert np.all(np.abs(q_g[1:] - q_r[1:]) <= _block_budget(x, sf).max())
        q = torch.from_numpy(q_g)
    else:
        ids_r, dcac_r = (np.asarray(a) for a in jf.fused_encode_ec(
            xj, jnp.float32(sf), EB, 1.0, False, "high"))
        ids_g, dcac_g = (a.numpy() for a in tf.fused_encode_ec(
            xt, torch.tensor(sf), EB, relaxed=True))
    budget = _block_budget(x, sf)[:, None]
    near = near_edge(torch.from_numpy(_ref_coef(x, sf)), torch.from_numpy(budget),
                     CodecConfig(mode=mode, error_bound=EB), q).numpy()
    differ = ids_g != ids_r
    assert not np.any(differ & ~near) and differ.mean() <= 1e-4
    esc = (ids_g == 255) & (ids_r == 255) & (np.arange(64) > 0)
    assert esc.sum() > 50
    lim = np.broadcast_to(budget, dcac_r.shape)
    if mode == "qt":
        lim = np.where(esc, budget * np.float32(EB * QTF) / q_g
                       + 4 * np.spacing(np.abs(dcac_r)), budget)
    assert np.all((np.abs(dcac_g - dcac_r) <= lim)[~differ])


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_screen_counts_take_the_relaxed_budget(mode):
    """_screen_counts with relaxed=True screens against 1024 eps *
    max|x/sf| (dpk_fuse.py:603-607), as an independent count does, and so
    flags more blocks than the 32-eps budget; the blocks that miss the
    tolerance do not depend on the budget."""
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.core import transform
    from dctz_tpu_torch.ops import dpk_fuse as td
    from dctz_tpu_torch.ops import fused_encode as tf
    from dctz_tpu_torch.ops import repair

    n = 3 * TILE_N
    x = signal(n, 9)  # at sf = 100 some blocks lie between the two budgets
    xt, sf = torch.from_numpy(x), torch.tensor(np.float32(100.0))
    tol = tf.tolerance(xt, n, EB)
    cfg = CodecConfig(mode=mode, error_bound=EB)
    q = (torch.clamp_min(tf._qtable_qmax_plain(xt, sf, cfg, True), 1.0)
         if mode == "qt" else None)
    coef = transform.block_dct((xt / sf).reshape(-1, 64), "high")
    ids = (qz.encode_ids_qt(coef, n, cfg, q) if q is not None
           else qz.encode_ids(coef, n, cfg))
    flagged, missed = td._screen_counts(xt, coef, ids, sf, tol, n, cfg, q, True)
    flagged_h, missed_h = td._screen_counts(xt, coef, ids, sf, tol, n, cfg, q, False)
    acm = qz.ac_mask(ids.shape[0], 64, n, xt.device)
    hat = qz.decode_dense(ids, coef[:, 0], repair.stored_dense(coef, ids, acm, cfg, q),
                          n, cfg, q).numpy()
    l2 = ((torch.from_numpy(hat) - coef) ** 2).sum(1).numpy()  # torch's order, as A's twin
    mx = np.abs(x / np.float32(100.0)).reshape(-1, 64).max(1)
    thr = np.float32(tol / sf) - np.float32(1024.0 * EPS32) * mx
    assert flagged == int(((l2 > thr * thr) | (thr <= 0)).sum())
    assert missed == missed_h <= flagged_h < flagged


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_repair_fused_stays_highest(oracle_shuffle, mode, monkeypatch):
    """The fused non-DPK branch's verify-repair recomputes its coefficients
    at HIGHEST whatever cfg.dct_precision says, as dctz_tpu's _repair_fused
    does (dctz_tpu/api.py:308-320): on the relaxed kernel output, its result
    under dct_precision="high" is that under "highest", bit for bit, every
    forward transform it runs is HIGHEST, and its repaired ids agree with
    the JAX _repair_fused's within 1e-4."""
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu import api as ja
    from dctz_tpu.ops import fused_encode as jf
    from dctz_tpu_torch import api as ta
    from dctz_tpu_torch.core import transform

    n = 2 * TILE_N
    x = qt_signal(n, 21, narrow=True)
    sf = np.float32(4.0)
    fn = jf.fused_encode_qt if mode == "qt" else jf.fused_encode_ec
    out = fn(jnp.asarray(x), jnp.float32(sf), EB, 1.0, False, "high")
    ids, dcac = np.array(out[0]), np.array(out[1])
    qtable = np.array(out[2]) if mode == "qt" else None
    seen = []
    block_dct = transform.block_dct

    def spy(blocks, precision="highest"):
        seen.append(precision)
        return block_dct(blocks, precision)

    monkeypatch.setattr(transform, "block_dct", spy)
    args = (torch.from_numpy(x), torch.tensor(sf), torch.from_numpy(ids),
            torch.from_numpy(dcac[:, 0].copy()), n)
    qt = None if qtable is None else torch.from_numpy(qtable)
    q_hi, ok_hi = ta._repair_fused(*args, dz.CodecConfig(mode=mode, error_bound=EB,
                                                         dct_precision="high"), qt)
    q_lo, ok_lo = ta._repair_fused(*args, dz.CodecConfig(mode=mode, error_bound=EB), qt)
    assert seen and set(seen) == {"highest"}
    for a, b in zip(q_hi[:4], q_lo[:4]):
        assert torch.equal(a, b)
    assert bool(ok_hi) == bool(ok_lo)
    ref = ja._repair_fused(
        jnp.asarray(x), jnp.float32(sf), jnp.asarray(ids), jnp.asarray(dcac[:, 0]), n,
        dctz_tpu.CodecConfig(mode=mode, error_bound=EB, dct_precision="high"), None,
        None if qtable is None else jnp.asarray(qtable))
    ids_r = np.asarray(ref[0])
    assert (ids_r != ids).sum() > 0  # the repair fired
    assert np.mean(q_hi.bin_ids.numpy() != ids_r) <= 1e-4
    assert bool(ok_hi) == bool(ref[4])


#: the routes of dct_precision="high": (config keywords, n, the wrappers
#: that must get the option: True where they follow it, False where they
#: stay HIGHEST). The DPK routes run kernel A (and E in QT), the fused
#: non-DPK ones F or E + G and, with verify, the repair's HIGHEST
#: transform.forward; "v1_generic" takes the generic chain, whose
#: transform.forward follows the option
ROUTES = {
    "dpk_ec": (dict(container="v2", ids_codec="device", verify=True, segment_elems=0),
               5 * TILE_N - 11, {"dct_quant_verify": True}),
    "dpk_qt": (dict(mode="qt", container="v2", ids_codec="device", verify=True,
                    segment_elems=0), 5 * TILE_N - 11,
               {"qtable_qmax": True, "dct_quant_verify": True}),
    "dpk_ec_dtzs": (dict(container="v2", ids_codec="device", verify=True,
                         segment_elems=2 * TILE_N), 5 * TILE_N - 11,
                    {"dct_quant_verify": True}),
    "dpk_qt_dtzs": (dict(mode="qt", container="v2", ids_codec="device", verify=True,
                         segment_elems=2 * TILE_N), 5 * TILE_N - 11,
                    {"qtable_qmax": True, "dct_quant_verify": True}),
    "v1_ec": (dict(verify=True), 3 * TILE_N, {"dct_quant": True, "forward": False}),
    "v1_qt": (dict(mode="qt", verify=True), 3 * TILE_N,
              {"qtable_qmax": True, "dct_quant": True, "forward": False}),
    "v2_deflate": (dict(container="v2", ids_codec="deflate", verify=True, segment_elems=0),
                   3 * TILE_N + 128, {"dct_quant": True, "forward": False}),
    "v1_generic": (dict(verify=True), 7777, {"forward": True}),
}


def _spy_relaxed(monkeypatch):
    """Record the relaxed flag (or the transform's precision) with which
    each wrapper of a forward kernel is called."""
    from dctz_tpu_torch.core import transform
    from dctz_tpu_torch.ops import dpk_fuse as td
    from dctz_tpu_torch.ops import fused_encode as tf

    seen: dict = {}
    for mod, name in ((td, "dct_quant_verify"), (tf, "qtable_qmax"), (tf, "dct_quant")):
        fn = getattr(mod, name)

        def wrap(*a, _fn=fn, _name=name, relaxed=False, **k):
            seen.setdefault(_name, set()).add(relaxed)
            return _fn(*a, relaxed=relaxed, **k)

        monkeypatch.setattr(mod, name, wrap)
    forward = transform.forward

    def fwd(xs, bs, precision="highest"):
        seen.setdefault("forward", set()).add(precision == "high")
        return forward(xs, bs, precision)

    monkeypatch.setattr(transform, "forward", fwd)
    return seen


@pytest.mark.parametrize("route", list(ROUTES))
def test_relaxed_routes_pass_the_option(route, monkeypatch):
    """Each route's forward-kernel wrappers get relaxed=True under
    dct_precision="high" and relaxed=False under "highest" (on a CUDA
    tensor each then launches its RELAXED or HIGHEST instantiation:
    tests/test_torch_cuda.py); the fused branch's repair transform stays
    HIGHEST under either; and the container decodes within the bound."""
    import dctz_tpu_torch as dz

    kw, n, want = ROUTES[route]
    x = qt_signal(n, n + 1)
    for prec in ("high", "highest"):
        seen = _spy_relaxed(monkeypatch)
        blob = dz.compress(x, config=dz.CodecConfig(error_bound=EB, dct_precision=prec,
                                                    **kw), device="cpu")
        assert seen == {k: {follows and prec == "high"} for k, follows in want.items()}
        assert np.abs(dz.decompress(blob, device="cpu") - x).max() <= bound(x)
        monkeypatch.undo()


@pytest.mark.parametrize("route", list(ROUTES))
def test_relaxed_containers_match_reference(oracle_shuffle, route):
    """dct_precision="high" on every route, against dctz_tpu's container of
    the same input and configuration: each package decodes the other's
    within the bound, the port's decode of the reference container within
    32 ulp of sf of the reference's own, the headers' n, mode and sf equal
    and their means within the ulp budget, and the ratio within 0.1% of
    the reference's (not on v1_generic: dctz_tpu's XLA chain, where HIGH is
    a no-op on the CPU)."""
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import container as ct

    kw, n, _want = ROUTES[route]
    x = qt_signal(n, n + 2)
    cfg_kw = dict(error_bound=EB, dct_precision="high", **kw)
    port_blob = dz.compress(x, config=dz.CodecConfig(**cfg_kw), device="cpu")
    ref_blob = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(**cfg_kw))
    assert (port_blob[:4] == b"DTZS") == (ref_blob[:4] == b"DTZS")
    assert np.abs(np.asarray(dctz_tpu.decompress(port_blob)) - x).max() <= bound(x)
    got = dz.decompress(ref_blob, device="cpu")
    assert got.shape == x.shape and np.abs(got - x).max() <= bound(x)
    ref = np.asarray(dctz_tpu.decompress(ref_blob))
    dtzs = port_blob[:4] == b"DTZS"
    frames_p = _frames(port_blob) if dtzs else [port_blob]
    frames_r = _frames(ref_blob) if dtzs else [ref_blob]
    assert len(frames_p) == len(frames_r)
    for fp, fr in zip(frames_p, frames_r):
        parse = ct.parse_v1 if ct.detect_format(fr) == "v1" else ct.parse_v2
        hp, hr = parse(fp)[0], parse(fr)[0]
        assert (hp.num_elements, hp.mode, hp.scaling_factor) == (
            hr.num_elements, hr.mode, hr.scaling_factor)
        assert_mean_close(hp, hr, x)
    assert np.abs(got - ref).max() <= 32 * EPS32 * hr.scaling_factor
    if route != "v1_generic":
        assert abs(len(port_blob) / len(ref_blob) - 1.0) <= 1e-3, (len(port_blob),
                                                                 len(ref_blob))
