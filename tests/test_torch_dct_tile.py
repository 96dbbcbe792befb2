"""Kernels A, D, E, F and G work on CUDA block tiles of 64 DCT blocks
(csrc/dct_tile.cuh): lengths that are a multiple of 1024 but not of the
tile, A's optional screen counters and the 16-byte alignment of the kernels'
inputs, on the plain versions here; the same edges on the card are in
tests/test_torch_cuda.py. Also: the cuts of the stage-timing tool
(kernels/stage_split.py) still find their text in the sources."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_oracle import EB, EPS32, oracle, signal  # noqa: F401
from test_torch_qt import qt_signal

torch.set_num_threads(2)

CTA_N = 64 * 64
RAGGED = [5 * 1024, 5 * 1024 - 11, 3 * CTA_N + 2048 - 11]


def _narrow(n_valid, seed):
    """A narrow range off zero, zero-padded to 1024: the repair has work."""
    x = signal(n_valid, seed)
    x = (np.float32(11.0) + x * np.float32(0.02)).astype(np.float32)
    n_pad = n_valid + (-n_valid) % 1024
    return np.concatenate([x, np.zeros(n_pad - n_valid, np.float32)])


def _tol(x, n_valid):
    from dctz_tpu.ops.repair import _SLACK

    span = x[:n_valid].max() - x[:n_valid].min()
    return np.float32(span * np.float32(EB) * np.float32(_SLACK))


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("n_valid", RAGGED)
def test_encode_x_fused_at_ragged_lengths(oracle, verify, n_valid):
    """The whole encode at lengths whose padded size is not a multiple of
    A's 64-block tile: the Pallas encode_x_fused's ids within 1e-4, the same
    verify and overflow flags, DC within 32 ulp of the block's max|x/sf|."""
    from dctz_tpu.core.quantize import chunk_width
    from dctz_tpu.ops import dpk_fuse as jd
    from dctz_tpu_torch.ops import dpk_fuse as td

    x = _narrow(n_valid, n_valid)
    n_pad = x.size
    assert n_pad % CTA_N
    sf, tol = np.float32(10.0), _tol(x, n_valid)
    cw = chunk_width(n_pad, 64)
    ref = jd.encode_x_fused(jnp.asarray(x), jnp.float32(sf), jnp.float32(tol),
                            n_valid, EB, 128, cw, verify)
    got = td.encode_x_fused(torch.from_numpy(x), torch.tensor(sf), torch.tensor(tol),
                            n_valid, EB, 128, cw, verify)
    nblk = n_pad // 64
    ids_r = td.dpk_unpack_expand(*[torch.as_tensor(np.array(ref[i])) for i in (0, 1, 2, 4)],
                                 nblk, n_pad, cw)[0]
    ids_g = td.dpk_unpack_expand(got[0], got[1], got[2], got[4], nblk, n_pad, cw)[0]
    assert (ids_r != ids_g).float().mean().item() <= 1e-4
    assert bool(ref[8]) == bool(got[8]) and bool(ref[7]) == bool(got[7])
    budget = 32 * EPS32 * np.abs(x.reshape(-1, 64) / sf).max(axis=1)
    assert np.all(np.abs(np.asarray(ref[6]) - got[6].numpy()) <= budget)


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("n_valid", RAGGED)
def test_screen_counters(oracle, mode, n_valid):
    """The counters a verifying call adds: the blocks the L2 screen flags
    include every block whose reconstruction misses tol, and those include
    every block whose ids the reference's repair changed."""
    from dctz_tpu.ops import dpk_fuse as jd
    from dctz_tpu_torch.ops import dpk_fuse as td

    x = _narrow(n_valid, n_valid + 1)
    sf, tol = np.float32(10.0), _tol(x, n_valid)
    xt, sft, tolt = torch.from_numpy(x), torch.tensor(sf), torch.tensor(tol)
    q = None
    if mode == "qt":
        from dctz_tpu_torch.ops import fused_encode as fe

        q = torch.clamp_min(fe._qtable_qmax_plain(
            xt, sft, td._mode_cfg(EB, torch.ones(64))), 1.0)
    counters = torch.zeros(2, dtype=torch.int64)
    ids_v, _vals, ok = td.dct_quant_verify(xt, sft, tolt, n_valid, EB, True, q, counters)
    ids_0, _vals, _ok = td.dct_quant_verify(xt, sft, tolt, n_valid, EB, False, q, counters)
    flagged, missed = counters.tolist()
    changed = int((ids_v != ids_0).any(1).sum())
    assert 0 < changed <= missed <= flagged <= x.size // 64
    if mode == "ec":  # the reference's verify flag on the same input
        from dctz_tpu.core.quantize import chunk_width

        ref = jd.encode_x_fused(jnp.asarray(x), jnp.float32(sf), jnp.float32(tol),
                                n_valid, EB, 128, chunk_width(x.size, 64), True)
        assert bool(ref[8]) == bool(ok)


def _padded(x):
    return np.concatenate([x, np.zeros((-x.size) % 1024, np.float32)])


def _ulps(a, b):
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


@pytest.mark.parametrize("n_valid", RAGGED)
def test_qtable_qmax_at_ragged_lengths(oracle, n_valid):
    """Kernel E's twin against dctz_tpu's qtable_qmax (interpret mode) where
    the padded length is not a multiple of E's 64-block tile: within 4 ulp."""
    from dctz_tpu.ops import fused_encode as jf
    from dctz_tpu_torch.ops import fused_encode as tf

    x = _padded(qt_signal(n_valid, n_valid))
    assert x.size % CTA_N
    sf = np.float32(100.0)
    ref = np.asarray(jf.qtable_qmax(jnp.asarray(x), jnp.float32(sf), EB))
    got = tf.qtable_qmax(torch.from_numpy(x), torch.tensor(sf), EB).numpy()
    assert got.dtype == np.float32 and got.shape == (64,)
    assert (ref[1:] > 1.0).sum() > 10  # the table is not all clamped
    assert _ulps(got, ref).max() <= 4


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("n_valid", RAGGED)
def test_fused_encode_at_ragged_lengths(oracle, mode, n_valid):
    """Kernels F and G's twin against dctz_tpu's fused_encode_ec /
    fused_encode_qt (interpret mode) where the padded length is not a
    multiple of their 64-block tile: ids within 1e-4; DC and stored values
    within 32 ulp of the block's max|x/sf| (a stored QT escape: that times
    eb*qt_factor/q[k], plus 4 ulp); the qtable within 4 ulp."""
    from dctz_tpu.ops import fused_encode as jf
    from dctz_tpu_torch.ops import fused_encode as tf

    x = _padded(qt_signal(n_valid, n_valid + 3) if mode == "qt" else signal(n_valid, n_valid + 3))
    assert x.size % CTA_N
    sf = np.float32(100.0)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if mode == "qt":
        ids_r, dcac_r, q_r = (np.asarray(a) for a in jf.fused_encode_qt(xj, jnp.float32(sf), EB))
        ids_g, dcac_g, q_g = (a.numpy() for a in tf.fused_encode_qt(xt, torch.tensor(sf), EB))
        assert _ulps(q_g, q_r).max() <= 4
    else:
        ids_r, dcac_r = (np.asarray(a) for a in jf.fused_encode_ec(xj, jnp.float32(sf), EB))
        ids_g, dcac_g = (a.numpy() for a in tf.fused_encode_ec(xt, torch.tensor(sf), EB))
    assert ids_g.dtype == np.uint8 and ids_g.shape == ids_r.shape == (x.size // 64, 64)
    assert np.mean(ids_g != ids_r) <= 1e-4
    esc = (ids_g == 255) & (ids_r == 255) & (np.arange(64) > 0)
    assert esc.sum() > 0
    budget = 32 * EPS32 * np.abs(x.reshape(-1, 64) / sf).max(axis=1)[:, None]
    lim = np.broadcast_to(budget, dcac_r.shape)
    if mode == "qt":
        lim = np.where(esc, budget * np.float32(EB * 10.0) / q_g
                       + 4 * np.spacing(np.abs(dcac_r)), budget)
    assert np.all((np.abs(dcac_g - dcac_r) <= lim)[ids_g == ids_r])


@pytest.mark.parametrize("group", ["A", "B, C", "E, F", "L, M", "H, J", "K"])
def test_stage_split_cuts_find_their_text(group):
    """The stage-timing tool takes, for each kernel group, the first cut set
    whose every edit finds its text: in this checkout that is the newest
    set, and each of its edits finds its text exactly once, so a later edit
    of a kernel cannot leave the tool timing an uncut kernel."""
    from dctz_tpu_torch.kernels import build
    from dctz_tpu_torch.kernels import stage_split as ss

    srcs, sets = ss.GROUPS[group]
    name, cuts = ss.cut_sets(build.CSRC)[group]
    assert name == list(sets)[-1]
    assert {src for src, _edits in cuts.values()} == set(srcs)
    for variant, (src, edits) in cuts.items():
        text = (build.CSRC / src).read_text()
        for old, _new in edits:
            assert text.count(old) == 1, (variant, old)


def test_counters_are_checked():
    from dctz_tpu_torch.ops import dpk_fuse as td

    x = torch.zeros(1024)
    one = torch.ones(())
    for bad, err in ((torch.zeros(2, dtype=torch.int32), TypeError),
                     (torch.zeros(3, dtype=torch.int64), ValueError)):
        with pytest.raises(err):
            td.dct_quant_verify(x, one, one, 1024, EB, True, None, bad)


def test_aligned16_copies_only_a_misaligned_view():
    from dctz_tpu_torch.ops import dpk_fuse as td

    base = torch.arange(4096, dtype=torch.float32)
    assert td._aligned16(base) is base
    view = base[1:1025]
    got = td._aligned16(view)
    assert got is not view and got.data_ptr() % 16 == 0 and torch.equal(got, view)
    aligned_view = base[4:]
    assert td._aligned16(aligned_view) is aligned_view


def test_occupancy_is_reported_for_every_kernel():
    """The kernels' library exports a resident-CTAs query for every kernel
    that has a launch counter, with no arguments (the library is built and
    loaded only on a machine with nvcc)."""
    from dctz_tpu_torch.kernels import build
    from dctz_tpu_torch.ops import dpk_fuse as td

    assert set(build.OCCUPANCY) == set(td.LAUNCHES)
    for k in build.OCCUPANCY:
        assert build.SIGNATURES[f"dctz_ctas_per_sm_{k}"] == []
