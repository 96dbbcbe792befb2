"""The port's core modules against dctz_tpu: basis, transform, bins, repair,
scaling factor, compaction and container parsing."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_oracle import EB, EPS32, signal

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"
GOLDEN_FILES = sorted(p.name for p in GOLDEN.glob("*.z"))


def test_basis_byte_equal():
    from dctz_tpu.core import transform as jt
    from dctz_tpu_torch.core import transform as tt

    for n in (64, 33):
        assert jt._dct2_basis_np(n).tobytes() == tt._dct2_basis_np(n).tobytes()
        f32 = np.asarray(jt.dct2_basis(n, jnp.float32))
        assert tt.dct2_basis(n, "cpu").numpy().tobytes() == f32.tobytes()
    for fwd in (True, False):
        assert (jt._blockdiag_np(64, 2, fwd).tobytes()
                == tt._blockdiag_np(64, 2, fwd).tobytes())


def test_forward_dct_within_budget():
    """fp32 sums in another order: within 32 ulp of max|xs| per block."""
    from dctz_tpu.core import transform as jt
    from dctz_tpu_torch.core import transform as tt

    xs = signal(4 * 16384, 3) / np.float32(10.0)
    ref = np.asarray(jt.block_dct_flat(jnp.asarray(xs), 64))
    got = tt.block_dct(torch.from_numpy(xs).reshape(-1, 64)).numpy()
    budget = 32 * EPS32 * np.abs(xs.reshape(-1, 64)).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - ref) <= budget)


def _ref_coeffs(x, sf):
    from dctz_tpu.core import transform as jt

    xs = jnp.asarray(x) / jnp.float32(sf)
    return np.asarray(jt.block_dct_flat(xs, 64))


@pytest.mark.parametrize("n", [2 * 16384, 3 * 16384 - 64 * 5])
def test_ec_bins_byte_equal_given_ref_coeffs(n):
    from dctz_tpu.config import CodecConfig as JCfg
    from dctz_tpu.core import quantize as jq
    from dctz_tpu_torch.config import CodecConfig as TCfg
    from dctz_tpu_torch.core import quantize as tq

    x = signal(n, n)
    coeffs = _ref_coeffs(x, 10.0)
    jcfg = JCfg(error_bound=EB)
    q = jq.encode(jnp.asarray(coeffs), n, jcfg, compaction="global")
    got = tq.encode_ids(torch.from_numpy(coeffs.copy()), n, TCfg(error_bound=EB))
    assert np.array_equal(got.numpy().astype(np.uint8), np.asarray(q.bin_ids))


def test_repair_decisions_byte_equal_given_ref_coeffs():
    """Verify-repair forces the same coefficients to ESCAPE (spiky input so
    that repair really fires) and agrees on the verified flag."""
    from dctz_tpu.config import CodecConfig as JCfg
    from dctz_tpu.core import quantize as jq
    from dctz_tpu.ops import repair as jr
    from dctz_tpu_torch.config import CodecConfig as TCfg
    from dctz_tpu_torch.core import quantize as tq
    from dctz_tpu_torch.ops import repair as tr

    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        rng = np.random.default_rng(11)
        n = 2 * 16384
        # a narrow range far from zero: the tolerance sits below the bin
        # error, so many blocks violate the bound before repair
        x = (11.0 + rng.standard_normal(n) * 0.5).astype(np.float32)
        sf = np.float32(10.0)
        coeffs = _ref_coeffs(x, sf)
        tol = np.float32((x.max() - x.min()) * np.float32(EB) * np.float32(0.99))
        jcfg = JCfg(error_bound=EB)
        q = jq.encode(jnp.asarray(coeffs), n, jcfg, compaction="global")
        ids_j, _d, ok_j = jr.verify_repair(
            jnp.asarray(x), jnp.asarray(coeffs), jnp.float32(sf), q.bin_ids,
            q.dc, None, n, n, jcfg, jnp.float32(tol),
        )
        c_t = torch.from_numpy(coeffs.copy())
        ids0 = tq.encode_ids(c_t, n, TCfg(error_bound=EB))
        ids_t, ok_t = tr.verify_repair(
            torch.from_numpy(x), c_t, torch.tensor(sf), ids0, c_t[:, 0], n, n,
            TCfg(error_bound=EB), torch.tensor(tol),
        )
        forced = np.asarray(ids_j) != np.asarray(q.bin_ids)
        assert forced.sum() > 0  # repair fired
        assert np.array_equal(ids_t.numpy().astype(np.uint8), np.asarray(ids_j))
        assert bool(ok_t) == bool(ok_j)
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("amax", [1e-7, 0.5, 1.0, 9.99, 10.0, 10.01, 123.4, 3e7])
def test_scaling_factor_equal(amax):
    from dctz_tpu.core.stats import scaling_factor as js
    from dctz_tpu_torch.core.stats import scaling_factor as ts

    ref = np.asarray(js(jnp.float32(amax), 1))
    got = ts(torch.tensor(amax, dtype=torch.float32), 1).numpy()
    assert ref.tobytes() == got.tobytes()


@pytest.mark.parametrize("sf_adj", [0, 1, 3])
def test_scaling_factor_matches_reference(sf_adj):
    """Float32 scaling factors equal dctz_tpu's for max|x| at every decade
    whose scaling factor is a normal float32, exact powers of ten and an
    ulp either side among them: the port takes XLA's float32 log10 (log(x)
    * (1 / ln 10)), whose ceiling torch's log10 misses near some powers
    of ten (10**9, 10**10, ...). Float64:
    test_scaling_factor_matches_reference_f64."""
    from dctz_tpu.core.stats import scaling_factor as js
    from dctz_tpu_torch.core.stats import scaling_factor as ts

    tiny = float(np.finfo(np.float32).tiny)
    for k in range(-36, 39):
        for m in (0.5, 1.0, 1 + 2.0 ** -20, 1 - 2.0 ** -20, 3.7):
            a = np.float32(m * 10.0 ** k)
            if not np.isfinite(a):
                continue
            ref = np.asarray(js(jnp.float32(a), sf_adj))
            if float(ref) < tiny:
                continue  # flushed to 0 by XLA (a divisor of 0): not mirrored
            got = ts(torch.tensor(a, dtype=torch.float32), sf_adj).numpy()
            assert ref.tobytes() == got.tobytes(), (k, m, float(ref), float(got))


@pytest.mark.parametrize("sf_adj", [0, 1, 3])
def test_scaling_factor_matches_reference_f64(sf_adj):
    """Float64 scaling factors (x64 on) equal dctz_tpu's, eager and jitted,
    bit for bit at max|x| = 10**k for k in -300..299 and an ulp either side:
    the port takes XLA's float64 log10, log(x) * float64(log10 e), whose
    ceiling torch's log10 and log(x) * (1 / ln 10) miss at some of these
    (1e-291, ...)."""
    from dctz_tpu.core.stats import scaling_factor as js
    from dctz_tpu_torch.core.stats import scaling_factor as ts

    with jax.enable_x64(True):
        jitted = jax.jit(js, static_argnums=1)
        for k in range(-300, 300):
            a = 10.0 ** k
            for v in (np.nextafter(a, 0.0), a, np.nextafter(a, np.inf)):
                got = ts(torch.tensor(v, dtype=torch.float64), sf_adj).numpy()
                for ref in (js(jnp.float64(v), sf_adj), jitted(jnp.float64(v), sf_adj)):
                    ref = np.asarray(ref)
                    assert ref.dtype == np.float64
                    assert ref.tobytes() == got.tobytes(), (k, v, float(ref), float(got))


def test_zigzag_tables_equal():
    from dctz_tpu.core import binning as jb
    from dctz_tpu_torch.core import binning as tb

    lin = torch.arange(255, dtype=torch.int32)
    assert np.array_equal(tb.linear_to_zigzag(lin, 255).numpy(),
                          jb.conv_table_np(255))
    ids = torch.arange(255, dtype=torch.int32)
    ref = np.asarray(jb.zigzag_to_center(jnp.arange(255), jnp.float32(2e-3)))
    assert np.array_equal(tb.zigzag_to_center(ids, 2e-3).numpy(), ref)


@pytest.mark.parametrize("capc", [32, 128, 512])
def test_compaction_byte_equal(capc):
    from dctz_tpu.ops import compaction as jc
    from dctz_tpu_torch.ops import compaction as tc

    rng = np.random.default_rng(capc)
    mask = rng.random(64 * 512) < 0.2
    vals = rng.standard_normal(64 * 512).astype(np.float32)
    rows_j, cnt_j, ovf_j = jc.compact_chunked(jnp.asarray(mask), jnp.asarray(vals), 512, capc)
    rows_t, cnt_t, ovf_t = tc.compact_chunked(torch.from_numpy(mask), torch.from_numpy(vals), 512, capc)
    assert np.asarray(rows_j).tobytes() == rows_t.numpy().tobytes()
    assert np.array_equal(np.asarray(cnt_j), cnt_t.numpy())
    assert bool(ovf_j) == bool(ovf_t)
    m2 = mask.reshape(-1, 512) & (np.cumsum(mask.reshape(-1, 512), 1) <= capc)
    back_j = np.asarray(jc.expand_chunked(jnp.asarray(m2), rows_j))
    back_t = tc.expand_chunked(torch.from_numpy(m2), rows_t).numpy()
    assert back_j.tobytes() == back_t.tobytes()


def _as_bytes(streams):
    return [[bytes(c) for c in s] for s in streams]


@pytest.mark.parametrize("name", GOLDEN_FILES)
def test_golden_containers_parse(name):
    """Every committed container parses through the port's container module
    with the reference's header fields and section bytes."""
    from dctz_tpu.core import container as jct
    from dctz_tpu_torch.core import container as tct

    blob = (GOLDEN / name).read_bytes()
    fmt = jct.detect_format(blob)
    assert tct.detect_format(blob) == fmt
    if fmt == "v2":
        hj, sj, qj, cj = jct.parse_v2(blob)
        ht, st, qt, ctb = tct.parse_v2(blob)
        assert _as_bytes(st) == _as_bytes(sj) and cj == ctb
    else:
        hj, *sj, qj = jct.parse_v1(blob)
        ht, *st, qt = tct.parse_v1(blob)
        assert [bytes(s) for s in st] == [bytes(s) for s in sj]
    assert dataclasses.asdict(ht) == dataclasses.asdict(hj)
    assert (qt is None) == (qj is None)
    if qj is not None:
        assert np.array_equal(np.asarray(qt), np.asarray(qj))


def test_golden_manifest_covers_all_files():
    manifest = json.loads((GOLDEN / "manifest.json").read_text())
    assert len(GOLDEN_FILES) == 28
    assert {f[:-2] for f in GOLDEN_FILES} == set(manifest)
