"""The port's encode kernels' plain versions against dctz_tpu's Pallas
kernels in interpret mode: kernel B's twin byte-equal to
dpk_fuse.encode_fused, the whole encode_x_fused within the stated budgets."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_oracle import EB, EPS32, TILE_N, id_stream, oracle, signal  # noqa: F401

torch.set_num_threads(2)

NAMES = ["width", "packed", "exc_rows", "exc_counts", "ac", "acc", "dc", "ovf"]


def _both_encode_fused(ids, vals, nv, cape, cw):
    from dctz_tpu.ops import dpk_fuse as jd
    from dctz_tpu_torch.ops import dpk_fuse as td

    ref = jd.encode_fused(jnp.asarray(ids), jnp.asarray(vals), nv, 256, cape, cw)
    got = td.encode_fused(torch.from_numpy(ids.copy()), torch.from_numpy(vals.copy()),
                          nv, 256, cape, cw)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("nblk,cw", [(256, None), (4096, None), (4096 + 128, None),
                                     (256 + 40, 128), (512 + 8, 256)])
def test_pack_compact_byte_equal(oracle, nblk, cw):
    """At the chunk width of the length (512) and at 128 and 256, which the
    JAX package's shorter containers use and the encoder takes as given."""
    from dctz_tpu.core.quantize import chunk_width

    rng = np.random.default_rng(nblk)
    ids, vals = id_stream(rng, nblk)
    cw = cw or chunk_width(nblk * 64, 64)
    ref, got = _both_encode_fused(ids, vals, nblk * 64 - 7, 128, cw)
    for r, g, name in zip(ref, got, NAMES):
        assert r.dtype == g.dtype and r.shape == g.shape, name
        assert r.tobytes() == g.tobytes(), name


def test_pack_compact_overflow_and_full_width_retry(oracle):
    """A dense exception stream overflows cape = 128 in some chunk rows
    (counts stay true, the flag is set) and the cape = cw retry holds all."""
    rng = np.random.default_rng(7)
    nblk = 512
    ids, vals = id_stream(rng, nblk, esc_p=0.35)
    for cape in (128, 512):
        ref, got = _both_encode_fused(ids, vals, nblk * 64, cape, 512)
        for r, g, name in zip(ref, got, NAMES):
            assert r.tobytes() == g.tobytes(), (cape, name)
        assert bool(got[7]) == (cape == 128)
        assert got[3].max() > 128


def _stream_ids(out, nblk, n_stream, cw):
    """Bin ids recovered from a set of encode streams (the port's plain
    unpack, which test_torch_dpk_decode holds byte-equal to the reference)."""
    from dctz_tpu_torch.ops import dpk_fuse as td

    width, packed, exc, _ec, ac, _acc, _dc = [torch.as_tensor(np.array(o)) for o in out[:7]]
    ids, _acv = td.dpk_unpack_expand(width, packed, exc, ac, nblk, n_stream, cw)
    return ids.numpy()


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("n_valid", [2 * TILE_N, 5 * TILE_N - 11])
def test_encode_x_fused_matches(oracle, verify, n_valid):
    from dctz_tpu.core.quantize import chunk_width
    from dctz_tpu.ops import dpk_fuse as jd
    from dctz_tpu.ops.repair import _SLACK
    from dctz_tpu_torch.ops import dpk_fuse as td

    x = signal(n_valid, n_valid + verify)
    if verify:  # a narrow range off zero: repair has work in many blocks
        x = (np.float32(11.0) + x * np.float32(0.02)).astype(np.float32)
    n_pad = n_valid + (-n_valid) % 1024
    x = np.concatenate([x, np.zeros(n_pad - n_valid, np.float32)])
    sf = np.float32(10.0)
    tol = np.float32((x[:n_valid].max() - x[:n_valid].min()) * np.float32(EB) * np.float32(_SLACK))
    cw = chunk_width(n_pad, 64)
    ref = jd.encode_x_fused(jnp.asarray(x), jnp.float32(sf), jnp.float32(tol),
                            n_valid, EB, 128, cw, verify)
    got = td.encode_x_fused(torch.from_numpy(x), torch.tensor(sf), torch.tensor(tol),
                            n_valid, EB, 128, cw, verify)
    nblk = n_pad // 64
    ids_r = _stream_ids(ref, nblk, n_pad, cw)
    ids_g = _stream_ids(got, nblk, n_pad, cw)
    assert np.mean(ids_r != ids_g) <= 1e-4
    assert bool(ref[8]) == bool(got[8])
    assert bool(ref[7]) == bool(got[7])
    xs = x.reshape(-1, 64) / sf
    budget = 32 * EPS32 * np.abs(xs).max(axis=1)
    assert np.all(np.abs(np.asarray(ref[6]) - got[6].numpy()) <= budget)
    if verify:  # repair really changed ids on this input
        plain = td.encode_x_fused(torch.from_numpy(x), torch.tensor(sf),
                                  torch.tensor(tol), n_valid, EB, 128, cw, False)
        assert not np.array_equal(_stream_ids(plain, nblk, n_pad, cw), ids_g)
