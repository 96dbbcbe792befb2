"""Kernels H, I, J and K's plain versions (ops/shuffle.py on CPU tensors)
against dctz_tpu's Pallas shuffle kernels in interpret mode, byte for byte:
stable chunk-row compaction (shuffle.compact_f32, compact_bytes), its inverse
(shuffle.expand) and the unified compaction of id bytes and AC values
(compact_unified) across row widths, densities and capacities that are not
lane multiples (tests/test_shuffle.py's grid), and chunk width 64, which the
TPU kernels do not take, against the sort and one-hot arms of
dctz_tpu.ops.compaction. Also the DPK id coding around them: idpack.pack_ids
(exceptions through H) and its numpy oracle, pack_ids_with_ac's kernel J
arm at a tile of 64, and its AC escape counts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_oracle import oracle, oracle_shuffle  # noqa: F401

torch.set_num_threads(2)

NC = 24


def _mask_vals(cw, density, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((NC, cw)) < density
    vals = rng.standard_normal((NC, cw)).astype(np.float32)
    return mask, vals


@pytest.mark.parametrize("capc", [96, 130])
@pytest.mark.parametrize("density", [0.0, 0.03, 0.25, 1.0])
@pytest.mark.parametrize("cw", [128, 256, 512, 1024])
def test_compact_f32_byte_equal(oracle_shuffle, cw, density, capc):
    from dctz_tpu.ops import shuffle as jsh
    from dctz_tpu_torch.ops import shuffle as tsh

    capc = min(capc, cw)
    mask, vals = _mask_vals(cw, density, cw + int(density * 100) + capc)
    ref = np.asarray(jsh.compact_f32(jnp.asarray(mask), jnp.asarray(vals), capc))
    rows, counts = tsh.compact_f32(torch.from_numpy(mask), torch.from_numpy(vals),
                                   capc)
    assert rows.numpy().tobytes() == ref.tobytes()
    assert np.array_equal(counts.numpy(), mask.sum(axis=1))


@pytest.mark.parametrize("capc", [96, 130])
@pytest.mark.parametrize("density", [0.0, 0.03, 0.25, 1.0])
@pytest.mark.parametrize("cw", [128, 256, 512])
def test_expand_byte_equal(oracle_shuffle, cw, density, capc):
    """shuffle.expand needs every row's count within the capacity: the
    mask keeps each row's first capc masked positions."""
    from dctz_tpu.ops import shuffle as jsh
    from dctz_tpu_torch.ops import shuffle as tsh

    capc = min(capc, cw)
    mask, _ = _mask_vals(cw, density, 7 * cw + int(density * 100) + capc)
    mask &= np.cumsum(mask, axis=1) <= capc
    rows = np.random.default_rng(capc).standard_normal((NC, capc)).astype(np.float32)
    ref = np.asarray(jsh.expand(jnp.asarray(mask), jnp.asarray(rows)))
    got = tsh.expand(torch.from_numpy(mask), torch.from_numpy(rows)).numpy()
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


def test_int32_rows_expand_byte_equal(oracle_shuffle):
    from dctz_tpu.ops import shuffle as jsh
    from dctz_tpu_torch.ops import shuffle as tsh

    rng = np.random.default_rng(11)
    mask = rng.random((20, 256)) < 0.3
    mask &= np.cumsum(mask, axis=1) <= 160
    rows = rng.integers(-1000, 1000, (20, 160)).astype(np.int32)
    ref = np.asarray(jsh.expand(jnp.asarray(mask), jnp.asarray(rows)))
    got = tsh.expand(torch.from_numpy(mask), torch.from_numpy(rows)).numpy()
    assert got.dtype == np.int32 and got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("density", [0.03, 0.5, 0.0, 1.0])
def test_chunk_width_64_matches_sort_arm(oracle_shuffle, density):
    """cw = 64 is not a shape of the TPU kernels: dctz_tpu's compact_chunked
    sorts and expand_chunked takes its one-hot arm; the port's plain H and I
    give the same bytes (kernel H and I take cw = 64 on the card)."""
    from dctz_tpu.ops import compaction as jc
    from dctz_tpu_torch.ops import compaction as tc

    rng = np.random.default_rng(64)
    n, cw, capc = 64 * 40, 64, 32
    mask = rng.random(n) < density
    vals = rng.standard_normal(n).astype(np.float32)
    rows_j, cnt_j, ovf_j = jc.compact_chunked(jnp.asarray(mask), jnp.asarray(vals),
                                              cw, capc)
    rows_t, cnt_t, ovf_t = tc.compact_chunked(torch.from_numpy(mask),
                                              torch.from_numpy(vals), cw, capc)
    assert rows_t.numpy().tobytes() == np.asarray(rows_j).tobytes()
    assert np.array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert bool(ovf_t) == bool(ovf_j)
    m2 = mask.reshape(-1, cw) & (np.cumsum(mask.reshape(-1, cw), axis=1) <= capc)
    back_j = np.asarray(jc.expand_chunked(jnp.asarray(m2), rows_j))
    back_t = tc.expand_chunked(torch.from_numpy(m2), rows_t).numpy()
    assert back_t.tobytes() == back_j.tobytes()


@pytest.mark.parametrize("density", [0.25, 1.0])
def test_chunk_width_64_full_capacity_matches_sort_arm(oracle_shuffle, density):
    """cw = 64 at capacity 64, the overflow retry's width: the port's plain
    H against dctz_tpu's sort arm, rows and true counts."""
    from dctz_tpu.ops import compaction as jc
    from dctz_tpu_torch.ops import compaction as tc

    rng = np.random.default_rng(640)
    n, cw = 64 * 40, 64
    mask = rng.random(n) < density
    vals = rng.standard_normal(n).astype(np.float32)
    rows_j, cnt_j, ovf_j = jc.compact_chunked(jnp.asarray(mask), jnp.asarray(vals), cw, cw)
    rows_t, cnt_t, ovf_t = tc.compact_chunked(torch.from_numpy(mask),
                                              torch.from_numpy(vals), cw, cw)
    assert rows_t.numpy().tobytes() == np.asarray(rows_j).tobytes()
    assert np.array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert not bool(ovf_t) and not bool(ovf_j)


#: (cw, row bytes, byte-input offsets from 16 bytes, instantiation)
WALK_RULE = [
    (64, 4 * 64, (0,), "words"), (128, 4 * 128, (0,), "words"),
    (256, 4 * 96, (0,), "words"), (512, 4 * 130, (0,), "words"),
    (512, 128 + 4 * 128, (0, 0), "words"), (1024, 4 * 1024, (0,), "words"),
    (1536, 4 * 96, (0,), "words"), (2048, 2048 + 4 * 2048, (0, 0), "words"),
    (32, 4 * 32, (0,), "lanes"), (96, 4 * 96, (0,), "lanes"),
    (192, 4 * 96, (0,), "lanes"), (384, 4 * 130, (0,), "lanes"),
    (640, 4 * 130, (0,), "lanes"), (512, 4 * 128, (1,), "lanes"),
    (512, 128 + 4 * 128, (0, 8), "lanes"), (128, 4 * 128, (4,), "lanes"),
    (4096, 4 * 4096, (0,), "lanes"), (2048, 4 * 2048, (0,), "words"),
    (64, 4 * 64, (16,), "words"),
    # K: rows of min(capc, cw) bytes, the mask and the bytes aligned
    (512, 128, (0, 0), "words"), (64, 64, (0, 0), "words"),
    (1024, 130, (0, 16), "words"), (8192, 8192, (0, 0), "words"),
    (512, 128, (0, 1), "lanes"), (512, 128, (4, 0), "lanes"),
    (384, 128, (0, 0), "lanes"), (16384, 16384, (0, 0), "lanes"),
]


@pytest.mark.parametrize("cw,row_bytes,offsets,walk", WALK_RULE)
def test_walk_of_rule(cw, row_bytes, offsets, walk):
    """Kernels H, J and K take their word walk at chunk widths 64, 128, 256
    and multiples of 512 with 16-byte aligned byte inputs and rows whose
    staging fits (8 rows of 4096 floats, or of 16384 bytes, do not); else
    their lane walk."""
    from dctz_tpu_torch.ops import shuffle as tsh

    ptrs = [4096 * (i + 1) + off for i, off in enumerate(offsets)]
    assert tsh.walk_of(cw, row_bytes, *ptrs) == walk
    for kernel in ("chunk_compact", "chunk_compact_unified", "chunk_compact_bytes"):
        assert tsh._instantiation(kernel, walk) == (
            kernel if walk == "words" else kernel + "_lanes")


def _id_bytes(cw, seed):
    """Random id bytes, about a third of them ESCAPE."""
    rng = np.random.default_rng(seed)
    idb = rng.integers(0, 255, (NC, cw)).astype(np.uint8)
    return np.where(rng.random((NC, cw)) < 0.3, np.uint8(255), idb)


@pytest.mark.parametrize("capc", [96, 130])
@pytest.mark.parametrize("density", [0.0, 0.03, 0.25, 1.0])
@pytest.mark.parametrize("cw", [128, 512])
def test_compact_bytes_byte_equal(oracle_shuffle, cw, density, capc):
    """Kernel K's plain version: min(capc, cw) columns (capc 130 at cw 128
    gives 128), as dctz_tpu's compact_bytes."""
    from dctz_tpu.ops import shuffle as jsh
    from dctz_tpu_torch.ops import shuffle as tsh

    mask, _ = _mask_vals(cw, density, 3 * cw + int(density * 100) + capc)
    byt = _id_bytes(cw, capc)
    ref = np.asarray(jsh.compact_bytes(jnp.asarray(mask), jnp.asarray(byt), capc))
    got = tsh.compact_bytes(torch.from_numpy(mask), torch.from_numpy(byt), capc).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape == (NC, min(capc, cw))
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("cape,capc", [(96, 96), (130, 130), (96, 130)])
@pytest.mark.parametrize("density", [0.0, 0.03, 0.25, 1.0])
@pytest.mark.parametrize("cw", [128, 512, 1024])
def test_compact_unified_byte_equal(oracle_shuffle, cw, density, cape, capc):
    """Kernel J's plain version: the exception bytes and the AC values of
    the ESCAPE bytes among the first min(cw, ceil128(cape)) exceptions (the
    JAX kernel's cut: at cape 96 and cw 512 that is 128, not 96)."""
    from dctz_tpu.ops import shuffle as jsh
    from dctz_tpu_torch.ops import shuffle as tsh

    mask, vals = _mask_vals(cw, density, 5 * cw + int(density * 100) + cape + capc)
    idb = _id_bytes(cw, cape + capc)
    ref = [np.asarray(a) for a in jsh.compact_unified(
        jnp.asarray(mask), jnp.asarray(idb), jnp.asarray(vals), cape, capc)]
    got = [a.numpy() for a in tsh.compact_unified(
        torch.from_numpy(mask), torch.from_numpy(idb), torch.from_numpy(vals), cape, capc)]
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype and g.shape == r.shape and g.tobytes() == r.tobytes()


def _pack_ids_np(ids2d, n_valid, b):
    """Numpy oracle of pack_ids with unbounded exception capacity, in the
    tight layout a host assembles: (widths (T, bs) u8, the packed bytes of
    every tile and position at its width, the exception bytes in block-major
    order, exc_counts per block-major chunk row)."""
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.ops import idpack as ti

    nblk, bs = ids2d.shape
    t = ti.tiles_of(nblk, b)
    pos = np.arange(nblk * bs).reshape(nblk, bs)
    col = np.arange(bs)[None, :]
    valid = (pos < n_valid) & (col >= 1)
    ids_i = np.where(valid, ids2d.astype(np.int64), 0)
    nib_bm = np.minimum(ids_i, 15)
    padw = t * b - nblk
    nib_p = np.pad(nib_bm, ((0, padw), (0, 0))) if padw else nib_bm
    tiles = nib_p.reshape(t, b, bs).swapaxes(1, 2)  # (T, bs, B)

    maxv = tiles.max(axis=-1)
    costs = [np.where(maxv == 0, 0, ti._INF)]
    for wb in (1, 2, 3, 4):
        costs.append(wb * b + ti.EXC_BITS * (tiles >= (1 << wb) - 1).sum(axis=-1))
    width = np.argmin(np.stack(costs), axis=0)  # (T, bs)

    out = []
    for tile in range(t):
        for j in range(bs):
            wb = int(width[tile, j])
            if wb == 0:
                continue
            clipped = np.minimum(tiles[tile, j], (1 << wb) - 1)
            if wb != 3:
                g = 8 // wb
                shifts = np.arange(g, dtype=np.int64) * wb
                out.append((clipped.reshape(-1, g) << shifts).sum(axis=-1)
                           .astype(np.uint8).tobytes())
            else:
                shifts = np.arange(8, dtype=np.int64) * 3
                w24 = (clipped.reshape(-1, 8) << shifts).sum(axis=-1)
                by = np.stack([w24 & 255, (w24 >> 8) & 255, (w24 >> 16) & 255],
                              axis=-1)
                out.append(by.astype(np.uint8).tobytes())

    thr_t = np.where(width > 0, (1 << width) - 1, ti._INF)  # (T, bs)
    thr_bm = np.broadcast_to(thr_t[:, None, :], (t, b, bs)).reshape(t * b, bs)[:nblk]
    exc_mask = nib_bm >= thr_bm
    exc = ids_i[exc_mask].astype(np.uint8)
    counts = exc_mask.reshape(-1, qz.chunk_width(nblk * bs, bs)).sum(axis=-1)
    return width.astype(np.uint8), b"".join(out), exc.tobytes(), counts


@pytest.mark.parametrize("b", [64, 256])
def test_pack_ids_byte_equal(oracle_shuffle, b):
    """pack_ids against dctz_tpu's pack_ids (its exceptions through the
    Pallas compact_f32), and this file's numpy oracle against dctz_tpu's
    pack_ids_np and pack_ids' tight exception bytes, on a grid whose last
    tile is partial (chunk width 256)."""
    from dctz_tpu.ops import idpack as ji
    from dctz_tpu_torch.ops import idpack as ti

    from test_torch_oracle import id_stream

    nblk = 700
    ids, _ = id_stream(np.random.default_rng(b), nblk)
    n_valid = nblk * 64 - 5
    ref = [np.asarray(a) for a in ji.pack_ids(jnp.asarray(ids), n_valid, b, 128)]
    got = [a.numpy() for a in ti.pack_ids(torch.from_numpy(ids), n_valid, b, 128)]
    assert got[2].shape == (nblk * 64 // 256, 128)
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype and g.shape == r.shape and g.tobytes() == r.tobytes()
    oracle_np = _pack_ids_np(ids, n_valid, b)
    for r, g in zip(ji.pack_ids_np(ids, n_valid, b), oracle_np):
        assert np.array_equal(np.asarray(g), np.asarray(r))
    tight = b"".join(got[2][i, : got[3][i]].tobytes() for i in range(len(got[3])))
    assert tight == oracle_np[2]


@pytest.mark.parametrize("cape", [128, 256])
def test_pack_ids_with_ac_unified_arm(oracle_shuffle, cape):
    """At tile 64 dctz_tpu's pack_ids_with_ac takes its compact_unified arm
    (tests/test_shuffle.py's recipe); the port's kernel J arm (J's plain
    version on CPU tensors) and its plain version give the same bytes."""
    from dctz_tpu.ops import idpack as ji
    from dctz_tpu_torch.ops import idpack as ti

    from test_torch_oracle import id_stream

    nblk = 512
    ids, vals = id_stream(np.random.default_rng(9), nblk)
    n_valid = nblk * 64 - 7
    ref = [np.asarray(a) for a in ji.pack_ids_with_ac(
        jnp.asarray(ids), jnp.asarray(vals), n_valid, 64, cape)]
    args = (torch.from_numpy(ids), torch.from_numpy(vals), n_valid, 64, cape)
    for got in (ti.pack_ids_with_ac(*args), ti._pack_ids_with_ac_unified(*args)):
        for r, g in zip(ref, got):
            g = g.numpy()
            assert g.dtype == r.dtype and g.shape == r.shape and g.tobytes() == r.tobytes()


@pytest.mark.parametrize("b", [64, 256])
def test_ac_chunk_counts_equal(oracle_shuffle, b):
    """pack_ids_with_ac's AC escape counts are dctz_tpu's ac_chunk_counts,
    the counts a DPK container stores, unclipped by the capacity."""
    from dctz_tpu.ops import idpack as ji
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.ops import idpack as ti

    from test_torch_oracle import id_stream

    ids, vals = id_stream(np.random.default_rng(4), 300, esc_p=0.1)
    n_valid = 300 * 64 - 100
    cw = qz.chunk_width(300 * 64, 64)
    ref = np.asarray(ji.ac_chunk_counts(jnp.asarray(ids), n_valid, cw))
    got = ti.pack_ids_with_ac(torch.from_numpy(ids), torch.from_numpy(vals), n_valid, b,
                              32)[5].numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert ref.max() > 32
