"""Kernels L and M's plain versions (ops/research on CPU tensors) against
dctz_tpu's research Pallas kernels in interpret mode: the one-pass DPK
encode (fused_encode_dpk) and decode (fused_decode_dpk).

Budgets: the DCT is a float32 matmul summed in another order than the JAX
kernel's, so a coefficient (an AC escape's stored value, a DC) may differ by
32 ulp of max|x/sf|, and a bin id only where a coefficient lies that close
to a bin edge (at most 1e-4 of them, as tests/test_torch_v1.py allows);
wherever the id grids agree, the integer streams are byte-equal. The
decodes agree within rtol 1e-6 and 1e-6 of max|x|, as
tests/test_fused_decode.py holds the JAX kernel to its XLA chain; a decode
of either side's streams holds the pointwise bound eb * (max - min).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_oracle import EB, EPS32, TILE_N

torch.set_num_threads(2)

BS = 64
SIGNALS = ["smooth", "spiky", "noisy", "zeros", "mixed"]
N_TAIL = TILE_N + 4096  # one full DPK tile and a partial tail tile
ID_MISMATCH_MAX = 1e-4


def _signals(n):
    """tests/test_fused_encode_dpk.py's five signals."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 100, n)
    return {
        "smooth": (np.sin(t) * 0.5).astype(np.float32),
        "spiky": (np.sin(t) * 0.5 + rng.standard_normal(n) * 0.01
                  + np.where(rng.random(n) < 5e-4, 10.0, 0.0)).astype(np.float32),
        "noisy": (rng.standard_normal(n) * 0.002).astype(np.float32),
        "zeros": np.zeros(n, np.float32),
        "mixed": np.where(np.arange(n) < n // 2, np.sin(t) * 0.5,
                          rng.standard_normal(n) * 0.002).astype(np.float32),
    }


def _encode_both(x, sf):
    from dctz_tpu.ops.research import fused_encode_dpk as fed
    from dctz_tpu_torch.ops.research import fused_encode_dpk as ted

    ref = [np.asarray(a) for a in fed.fused_encode_dpk(
        jnp.asarray(x), jnp.float32(sf), EB, True)]
    got = [a.numpy() for a in ted.fused_encode_dpk(
        torch.from_numpy(x), torch.tensor(sf, dtype=torch.float32), EB)]
    return ref, got


def _ids_of(streams, n):
    """The bin-id grid a set of L streams codes (the port's unpack_ids)."""
    from dctz_tpu_torch.ops import idpack

    w, pk, exc = (torch.from_numpy(np.array(a)) for a in streams[:3])
    return idpack.unpack_ids(w, pk, exc, n // BS, BS, 256, 512).numpy()


def _assert_streams_match(ref, got, x, sf):
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and r.shape == g.shape
    n = x.size
    ids_r, ids_g = _ids_of(ref, n), _ids_of(got, n)
    assert (ids_r != ids_g).mean() <= ID_MISMATCH_MAX
    lim = 32 * EPS32 * max(float(np.abs(x / np.float32(sf)).max()), 1.0)
    np.testing.assert_allclose(got[6], ref[6], rtol=0, atol=lim)  # DC, by value
    if np.array_equal(ids_r, ids_g):
        for i in (0, 1, 2, 3, 5):  # width, packed, exc_rows, exc_counts, ac_counts
            assert got[i].tobytes() == ref[i].tobytes(), i
        np.testing.assert_allclose(got[4], ref[4], rtol=0, atol=lim)
    return ids_r, ids_g


@pytest.mark.parametrize("name", SIGNALS)
def test_encode_plain_matches_reference(name):
    """Five signals over a full tile and a partial tail tile."""
    x = _signals(N_TAIL)[name]
    ref, got = _encode_both(x, 1.0)
    ids_r, ids_g = _assert_streams_match(ref, got, x, 1.0)
    assert np.array_equal(ids_r, ids_g)
    assert got[0].shape == (2, BS) and got[2].shape == (N_TAIL // 512, 128)
    assert got[6].shape == (N_TAIL // BS,)


def test_encode_plain_overflow_counts_tell():
    """Chunk rows past 128 escapes keep their first 128 (compact_chunked's
    rule), and the counts stay true."""
    rng = np.random.default_rng(9)
    n = 1024 * 32
    x = np.where(rng.random(n) < 0.5, rng.standard_normal(n) * 50, 0.0).astype(np.float32)
    ref, got = _encode_both(x, 1.0)
    assert (got[5] > 128).any() and (got[3] > 128).any()
    _assert_streams_match(ref, got, x, 1.0)
    np.testing.assert_array_equal(got[5], ref[5])


def test_encode_plain_scales_inside():
    from dctz_tpu_torch.ops.research import fused_encode_dpk as ted

    n = 1024 * 16
    x = (np.sin(np.linspace(0, 50, n)) * 500).astype(np.float32)
    a = ted.fused_encode_dpk(torch.from_numpy(x), torch.tensor(100.0), EB)
    b = ted.fused_encode_dpk(torch.from_numpy(x / np.float32(100.0)), torch.tensor(1.0), EB)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    ref, _ = _encode_both(x, 100.0)
    assert a[0].numpy().tobytes() == ref[0].tobytes()


def test_encode_refuses_a_partial_quantum():
    from dctz_tpu_torch.ops.research import fused_encode_dpk as ted

    with pytest.raises(ValueError, match="multiple of 1024"):
        ted.fused_encode_dpk(torch.zeros(1024 + 64), torch.tensor(1.0), EB)


def _build(rng, nblk, b, mode, esc_p, p=0.4):
    """Self-consistent decode inputs, tests/test_fused_decode.py's recipe:
    ids packed by dctz_tpu's pack_ids at full capacity, the exception
    stream re-padded to the smallest capacity tier covering its peak, a
    chunked AC stream of out-of-range values at the escapes."""
    from dctz_tpu.config import CodecConfig
    from dctz_tpu.core import constants as JC
    from dctz_tpu.core import entropy
    from dctz_tpu.core import quantize as jq
    from dctz_tpu.ops import compaction as jc
    from dctz_tpu.ops import idpack

    n = nblk * BS
    mag = rng.geometric(p=p, size=(nblk, BS)).astype(np.int64) - 1
    ids = np.minimum(mag * 8 // np.maximum(1, np.arange(BS) // 4)[None, :], 254)
    ids = np.where(rng.random((nblk, BS)) < esc_p, JC.ESCAPE, ids)
    ids[:, 0] = JC.ESCAPE
    ids = ids.astype(np.uint8)
    cfg = CodecConfig(mode=mode, error_bound=EB, container="v2", ids_codec="device")
    cw = jq.chunk_width(n, BS)
    width, packed, exc_full, exc_counts, ovf = idpack.pack_ids(jnp.asarray(ids), n, b, cw)
    assert not bool(ovf)
    counts = np.asarray(exc_counts)
    tight = np.concatenate([np.asarray(exc_full)[i, : counts[i]] for i in range(len(counts))])
    peak = int(counts.max())
    cape = next(c for c in [c for c in (32, 64, 128, 256) if c < cw] + [cw]
                if c >= min(peak, cw))
    assert cape <= 128
    exc_rows = entropy.pad_row_prefixes(tight.tobytes(), counts, cape, np.uint8)
    rmax = (JC.NBINS // 2 * 2 + 1) * EB
    dense = (rng.standard_normal((nblk, BS)) * 3 + 4 * rmax).astype(np.float32)
    esc = (ids == JC.ESCAPE) & (np.arange(BS)[None, :] >= 1)
    ac_rows, _c, ac_ovf = jc.compact_chunked(jnp.asarray(esc.reshape(-1)),
                                             jnp.asarray(dense.reshape(-1)), cw, min(128, cw))
    assert not bool(ac_ovf)
    dc = (rng.standard_normal(nblk) * 10).astype(np.float32)
    qt = (np.abs(rng.standard_normal(BS)).astype(np.float32) + 1.0) if mode == "qt" else None
    arrays = [np.asarray(a) for a in (width, packed, exc_rows, dc, ac_rows)]
    return cfg, n, cw, arrays, qt


def _decode_both(cfg, n, cw, arrays, qt, b, sf=37.5):
    import dctz_tpu_torch as dz
    from dctz_tpu.ops.research import fused_decode as fd
    from dctz_tpu_torch.ops.research import fused_decode as td

    width, packed, exc, dc, ac = arrays
    ref = np.asarray(fd.fused_decode_dpk(
        jnp.asarray(width), jnp.asarray(packed), jnp.asarray(exc), jnp.asarray(dc),
        jnp.asarray(ac), jnp.float32(sf), n, b, cw, cfg,
        None if qt is None else jnp.asarray(qt), True))
    tcfg = dz.CodecConfig(mode=cfg.mode, error_bound=cfg.error_bound)
    got = td.fused_decode_dpk(
        *(torch.from_numpy(np.array(a)) for a in (width, packed, exc, dc, ac)),
        torch.tensor(sf, dtype=torch.float32), n, b, cw, tcfg,
        None if qt is None else torch.from_numpy(qt)).numpy()
    return ref, got


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("b,esc_p", [(64, 0.01), (64, 0.05), (32, 0.0), (256, 0.02)])
def test_decode_plain_matches_reference(mode, b, esc_p):
    rng = np.random.default_rng(11)
    cfg, n, cw, arrays, qt = _build(rng, 4 * b, b, mode, esc_p)
    ref, got = _decode_both(cfg, n, cw, arrays, qt, b)
    assert got.shape == ref.shape == (n,)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_decode_plain_tail_tile():
    """A partial tail tile: its padding blocks select nothing and do not
    shift the chunk-local ranks."""
    rng = np.random.default_rng(5)
    b = 64
    cfg, n, cw, arrays, qt = _build(rng, 3 * b + 24, b, "ec", 0.005, p=0.85)
    ref, got = _decode_both(cfg, n, cw, arrays, qt, b)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_eligibility_gate():
    from dctz_tpu_torch.ops.research import fused_decode as td

    assert not td.eligible(torch.float64, 64, 256, 512, 128, 128)  # dtype
    assert not td.eligible(np.float64, 64, 256, 512, 128, 128)
    assert not td.eligible(torch.float32, 32, 256, 512, 128, 128)  # block size
    assert not td.eligible(torch.float32, 64, 256, 48, 128, 128)  # cw % bs
    assert not td.eligible(torch.float32, 64, 256, 512, 256, 128)  # cape
    assert not td.eligible(torch.float32, 64, 256, 512, 128, 512)  # capc
    assert not td.eligible(torch.float32, 64, 255, 512, 128, 128)  # odd tile
    assert not td.eligible(torch.float32, 64, 256, 512, 120, 128)  # cape % 16
    assert td.eligible(torch.float32, 64, 256, 512, 128, 128)
    assert td.eligible(np.float32, 64, 32, 512, 32, 64)


def test_decode_refuses_what_the_gate_refuses():
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.ops.research import fused_decode as td

    z = torch.zeros
    args = (z((1, BS), dtype=torch.uint8), z((BS, 128), dtype=torch.uint8),
            z((32, 256), dtype=torch.uint8), z(256), z((32, 128)), torch.tensor(1.0))
    with pytest.raises(ValueError, match="not eligible"):
        td.fused_decode_dpk(*args, TILE_N, 256, 512, dz.CodecConfig())
    with pytest.raises(ValueError, match="multiple of 64"):
        td.fused_decode_dpk(*args, TILE_N - 1, 256, 512, dz.CodecConfig())


def _sf_of(x):
    from dctz_tpu_torch.core.stats import amax_mean, scaling_factor

    return float(scaling_factor(amax_mean(torch.from_numpy(x), x.size)[0], 1))


@pytest.mark.parametrize("n", [4 * TILE_N, 5 * TILE_N - 1024])
def test_cross_decode_holds_the_bound(n):
    """Each side decodes the other's L streams (and the port its own) within
    eb * (max - min)."""
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu.ops.research import fused_decode as fd
    from dctz_tpu_torch.ops.research import fused_decode as td

    from dctz_tpu_torch.utils.bench_data import climate_formula_np

    x = climate_formula_np(n)  # the benchmark's array: no chunk row overflows
    sf = _sf_of(x)
    ref, got = _encode_both(x, sf)
    assert max(a.max() for a in (ref[3], ref[5], got[3], got[5])) <= 128
    tol = EB * float(x.max() - x.min())
    tcfg = dz.CodecConfig(error_bound=EB)
    sf_t = torch.tensor(sf, dtype=torch.float32)
    for w, pk, exc, _ec, ac, _acn, dc in (ref, got):
        y = td.fused_decode_dpk(*(torch.from_numpy(np.array(a))
                                  for a in (w, pk, exc, dc, ac)),
                                sf_t, n, 256, 512, tcfg).numpy()
        assert np.abs(y - x).max() <= tol
    w, pk, exc, _ec, ac, _acn, dc = got
    y = np.asarray(fd.fused_decode_dpk(
        *(jnp.asarray(a) for a in (w, pk, exc, dc, ac)), jnp.float32(sf), n, 256,
        512, dctz_tpu.CodecConfig(error_bound=EB), None, True))
    assert np.abs(y - x).max() <= tol


def test_research_gates_are_off_by_default():
    """As in the JAX package, the public API reaches neither one-pass entry
    point: they are called by name only."""
    import inspect

    from dctz_tpu_torch import api, stream

    for mod in (api, stream):
        assert "research" not in inspect.getsource(mod)


@pytest.mark.parametrize("b,cw,walk", [(256, 512, "words"), (64, 512, "words"),
                                       (64, 64, "words"), (256, 8192, "words"),
                                       (32, 2048, "words"), (96, 1024, "words"),
                                       (24, 192, "lanes"), (96, 384, "lanes"),
                                       (6, 128, "lanes")])
def test_m_instantiation_by_geometry(b, cw, walk):
    """Kernel M takes its word walk where b is a multiple of 8 and cw a
    power of two, else its lane walk; every case is a geometry the gate
    admits."""
    from dctz_tpu_torch.ops.research import fused_decode as td

    assert td.eligible(torch.float32, 64, b, cw, 128, 128)
    assert td.walk_of(b, cw) == walk


def test_references_take_the_plain_version_on_the_cpu():
    """The card-only references of L and M (ops/research/_ref.py) take the
    arguments of the wrappers they check; on CPU tensors both are the plain
    version."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.ops.research import _ref
    from dctz_tpu_torch.ops.research import fused_decode as td
    from dctz_tpu_torch.ops.research import fused_encode_dpk as ted
    from dctz_tpu_torch.utils.bench_data import climate_formula_np

    n = TILE_N + 2048
    x = torch.from_numpy(climate_formula_np(n))
    sf = torch.tensor(_sf_of(x.numpy()), dtype=torch.float32)
    got, ref = ted.fused_encode_dpk(x, sf, EB), _ref.fused_encode_dpk_ref(x, sf, EB)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    w, pk, exc, _ec, ac, _acn, dc = got
    cfg = dz.CodecConfig(error_bound=EB)
    y = td.fused_decode_dpk(w, pk, exc, dc, ac, sf, n, 256, 512, cfg)
    assert torch.equal(y, _ref.fused_decode_dpk_ref(w, pk, exc, dc, ac, sf, n, 256, 512, cfg))


def test_references_are_off_every_path():
    """Nothing in the port but ops/research/_ref.py names the reference
    kernels: chip_smoke.py and the card tests call them, no entry point."""
    import pathlib

    import dctz_tpu_torch

    root = pathlib.Path(dctz_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        if path.name in ("_ref.py", "build.py"):
            continue
        text = path.read_text()
        for name in ("fused_encode_dpk_ref", "fused_decode_dpk_ref", "import _ref"):
            assert name not in text, (path, name)
