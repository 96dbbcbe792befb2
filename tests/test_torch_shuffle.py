"""Kernels H and I's plain versions (ops/shuffle.py on CPU tensors) against
dctz_tpu's Pallas shuffle kernels in interpret mode, byte for byte: stable
chunk-row compaction (shuffle.compact_f32) and its inverse (shuffle.expand)
across row widths, densities and capacities that are not lane multiples
(tests/test_shuffle.py's grid), and chunk width 64, which the TPU kernels do
not take, against the sort and one-hot arms of dctz_tpu.ops.compaction."""

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
@pytest.mark.parametrize("cw", [128, 256, 512])
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


@pytest.mark.parametrize("density", [0.03, 0.5])
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
