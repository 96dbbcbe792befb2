"""The port's decode kernels' plain versions against dctz_tpu: kernel C's
twin byte-equal to idpack.unpack_ids (and the chunked AC expansion), the
plain decode_fused (C then D) within 32 ulp of sf of the Pallas
decode_fused in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_oracle import (  # noqa: F401
    EPS32, TILE_N, combine_planes, id_stream, oracle, signal, slice_cfg,
)

torch.set_num_threads(2)


def _streams(nblk, seed, esc_p=0.02):
    """DPK streams of a synthetic id grid, from the reference encoder."""
    from dctz_tpu.core.quantize import chunk_width
    from dctz_tpu.ops import dpk_fuse as jd

    rng = np.random.default_rng(seed)
    ids, vals = id_stream(rng, nblk, esc_p=esc_p)
    cw = chunk_width(nblk * 64, 64)
    out = jd.encode_fused(jnp.asarray(ids), jnp.asarray(vals), nblk * 64, 256, 128, cw)
    return [np.array(o) for o in out], cw


#: (nblk, esc_p, tier): the rows at their full capacity (tier None, 128) or
#: cut to a decode tier; nblk 258 and 260 give chunk widths 128 and 256
UNPACK_CASES = [(256, 0.02, None), (1024 + 128, 0.05, None), (258, 0.05, 32),
                (260, 0.02, 64), (260, 0.05, None), (256, 0.05, 32)]


@pytest.mark.parametrize("nblk,esc_p,tier", UNPACK_CASES)
def test_unpack_expand_byte_equal(oracle, nblk, esc_p, tier):
    from dctz_tpu.core import constants as C
    from dctz_tpu.ops import compaction as jc
    from dctz_tpu.ops import idpack as ji
    from dctz_tpu_torch.ops import dpk_fuse as td

    (width, packed, exc, _ec, ac, _acc, _dc, _ovf), cw = _streams(nblk, nblk, esc_p)
    exc, ac = _cut(exc, ac, tier)
    unpack = jax.jit(ji.unpack_ids, static_argnums=(3, 4, 5, 6))
    ref_ids = np.asarray(unpack(jnp.asarray(width), jnp.asarray(packed),
                                jnp.asarray(exc), nblk, 64, 256, cw))
    esc = (ref_ids == C.ESCAPE) & (np.arange(64) >= 1)
    ref_acv = np.asarray(jc.expand_chunked(jnp.asarray(esc.reshape(-1, cw)),
                                           jnp.asarray(ac))).reshape(nblk, 64)
    ids, acv = td.dpk_unpack_expand(*(torch.from_numpy(a) for a in (width, packed, exc, ac)),
                                    nblk, nblk * 64, cw)
    assert ids.numpy().tobytes() == ref_ids.tobytes()
    assert acv.numpy().tobytes() == ref_acv.tobytes()


def _cut(exc, ac, tier):
    """Exception and AC rows cut to a decode capacity tier (None: as they
    are): past the tier, exceptions read 0 and escapes no value."""
    if tier is None:
        return exc, ac
    return np.ascontiguousarray(exc[:, :tier]), np.ascontiguousarray(ac[:, :tier])


def _decode_inputs(blob):
    """The reference's host decode stage of a container (oracle active)."""
    from dctz_tpu import api
    from dctz_tpu.core import container as ct

    header, streams, _q, _cb = ct.parse_v2(blob)
    (width, rows, exc, dc, ac), (n_stream, _tb, cw, cfg, _lay) = api._dpk_decode_prep(
        header, streams
    )
    return (width, rows, exc, combine_planes(dc), combine_planes(ac),
            np.float32(header.scaling_factor), n_stream, cw, cfg)


@pytest.mark.parametrize("n", [2 * TILE_N, 5 * TILE_N - 11, (258, 32), (260, 64)])
def test_decode_fused_matches(oracle, n):
    """Containers of the JAX package, and synthetic streams at chunk widths
    128 and 256 with their rows cut to the decode tiers 32 and 64."""
    import dctz_tpu
    from dctz_tpu.ops import dpk_fuse as jd
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.ops import dpk_fuse as td

    if isinstance(n, tuple):
        nblk, tier = n
        (width, rows, exc, _ec, ac, _acc, dc, _ovf), cw = _streams(nblk, nblk, 0.05)
        exc, ac = _cut(exc, ac, tier)
        sf, n_stream, cfg = np.float32(3.0), nblk * 64, dctz_tpu.CodecConfig(error_bound=1e-3)
    else:
        blob = dctz_tpu.compress(signal(n, 5), config=slice_cfg(dctz_tpu))
        width, rows, exc, dc, ac, sf, n_stream, cw, cfg = _decode_inputs(blob)
    ref = np.asarray(jd.decode_fused(
        *(jnp.asarray(a) for a in (width, rows, exc, ac, dc)), jnp.float32(sf),
        cfg, cw, None,
    ))[:n_stream]
    got = td.decode_fused(
        *(torch.from_numpy(np.array(a)) for a in (width, rows, exc, ac, dc)),
        torch.tensor(sf), CodecConfig(error_bound=cfg.error_bound), cw, n_stream,
    ).numpy()
    assert got.shape == ref.shape
    if isinstance(n, tuple):  # 32 ulp of sf times the block's largest coefficient
        from dctz_tpu_torch.core import quantize as qz

        ids, acv = td.dpk_unpack_expand(*(torch.from_numpy(np.array(a)) for a in
                                          (width, rows, exc, ac)), nblk, n_stream, cw)
        co = qz.decode_dense(ids, torch.from_numpy(np.array(dc)), acv, n_stream,
                             CodecConfig(error_bound=1e-3)).abs().amax(1).clamp_min(1.0)
        lim = np.repeat(32 * EPS32 * sf * co.numpy(), 64)
        assert np.all(np.abs(got - ref) <= lim)
    else:
        assert np.abs(got - ref).max() <= 32 * EPS32 * sf
