"""The JAX oracle the port's tests hold it against, and checks of the oracle.

The oracle is dctz_tpu on the CPU with its fused TPU dispatch forced on: the
Pallas kernels run in interpret mode, chunk-local compaction is forced, and
x64 is off (the fused decode's gate needs it off; tests/conftest.py turns it
on). Without the force the CPU takes the XLA chain, whose containers store
the true length instead of the padded one. The other tests/test_torch_*.py
modules import the fixture and helpers from here.
"""

import numpy as np
import pytest
import torch

import jax

from torch_common import (  # noqa: F401
    MEAN_ULPS, _dpk_ids, assert_byte_equal, assert_mean_close, frames_of, parse_any,
)

torch.set_num_threads(2)

EB = 1e-3
EPS32 = 2.0 ** -23
TILE_N = 16384


@pytest.fixture(scope="module")
def oracle():
    """Module-scoped: the interpret-mode programs compile once per module and
    shape. The jit caches do not key on these switches, so they are cleared
    on the way in and on the way out."""
    from dctz_tpu.ops import compaction as cp
    from dctz_tpu.ops import dpk_fuse, fused_encode

    mp = pytest.MonkeyPatch()
    old_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    mp.setattr(cp, "use_chunked_compaction", lambda: True)
    mp.setattr(dpk_fuse, "_FORCE", True)
    mp.setattr(dpk_fuse, "_INTERPRET", True)
    mp.setattr(fused_encode, "_INTERPRET", True)
    jax.clear_caches()
    yield
    jax.clear_caches()
    mp.undo()
    jax.config.update("jax_enable_x64", old_x64)


@pytest.fixture(scope="module")
def oracle_shuffle(oracle):
    """The oracle with the Pallas shuffle kernels forced on as well
    (interpret mode): the non-DPK containers' compaction and expansion run
    through shuffle.compact_f32 / expand, as on the TPU. The jit caches do
    not key on these switches either (tests/test_shuffle.py), so they are
    cleared on the way in and out."""
    from dctz_tpu.ops import shuffle

    mp = pytest.MonkeyPatch()
    mp.setattr(shuffle, "_FORCE", True)
    mp.setattr(shuffle, "_INTERPRET", True)
    jax.clear_caches()
    yield
    jax.clear_caches()
    mp.undo()


def slice_cfg(pkg, **kw):
    """The benchmark's configuration in either package (monolithic)."""
    base = dict(mode="ec", error_bound=EB, container="v2", ids_codec="device",
                verify=True, segment_elems=0)
    base.update(kw)
    return pkg.CodecConfig(**base)


def signal(n: int, seed: int) -> np.ndarray:
    """Climate-shaped float32 test input with noise and rare spikes."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32)
    x = (np.sin(t * np.float32(0.003)) * np.float32(30.0)
         + rng.standard_normal(n).astype(np.float32) * np.float32(0.7))
    spikes = rng.random(n) < 2e-4
    return np.where(spikes, x * np.float32(9.0), x).astype(np.float32)


def bound(x: np.ndarray) -> float:
    return EB * float(x.max() - x.min())


def id_stream(rng, nblk, bs=64, esc_p=0.02):
    """Synthetic bin-id grid and values (tests/test_dpk_fuse.py's generator)."""
    from dctz_tpu.core import constants as C

    mag = rng.geometric(p=0.4, size=(nblk, bs)).astype(np.int64) - 1
    decay = np.maximum(1, np.arange(bs) // 4)
    ids = np.minimum(mag * 8 // decay[None, :], 254)
    ids = np.where(rng.random((nblk, bs)) < esc_p, C.ESCAPE, ids)
    ids[:, 0] = C.ESCAPE
    vals = rng.standard_normal((nblk, bs)).astype(np.float32)
    return ids.astype(np.uint8), vals


def combine_planes(a: np.ndarray) -> np.ndarray:
    """(4, ...) little-endian byte planes -> float32 (numpy)."""
    if a.dtype != np.uint8:
        return a.astype(np.float32)
    u = sum(a[k].astype(np.uint32) << np.uint32(8 * k) for k in range(4))
    return u.astype(np.uint32).view(np.float32)


def test_oracle_is_off_outside_the_fixture():
    from dctz_tpu.ops import compaction as cp
    from dctz_tpu.ops import dpk_fuse

    assert dpk_fuse._FORCE is None and not dpk_fuse._INTERPRET
    assert not cp.use_chunked_compaction()


def test_oracle_takes_the_fused_path(oracle):
    """Under the oracle a JAX container stores the PADDED length, as the
    fused TPU dispatch (and the port) do."""
    import dctz_tpu
    from dctz_tpu import api
    from dctz_tpu.core import container as ct

    n = 2 * TILE_N - 11
    blob = dctz_tpu.compress(signal(n, 1), config=slice_cfg(dctz_tpu))
    header, streams, _q, _cb = ct.parse_v2(blob)
    _arrays, (n_stream, tile_b, cw, _cfg, layout) = api._dpk_decode_prep(
        header, streams
    )
    assert (n_stream, tile_b, cw, layout) == (n + 11, 256, 512, "chunked")


@pytest.fixture
def ref_arithmetic(monkeypatch):
    """use_ref_arithmetic for the whole test."""
    use_ref_arithmetic(monkeypatch)


@pytest.fixture
def ref_inverse(monkeypatch):
    """The QT inverse ((v - side) / (eb * qt_factor)) * q as XLA compiles it
    on the CPU, where the divisor is a compile-time constant: the division
    becomes a product with the reciprocal, and the two products reassociate
    to (v - side) * (q * (1 / (eb * qt_factor))), rounded in the values'
    dtype. The port divides first, as the C codec does
    (dctz-decomp-lib.c:401-413)."""
    from dctz_tpu_torch.core import quantize as qz

    def qt_inverse(vals, qtable, cfg):
        _, rmin, rmax = qz._geometry(cfg, vals.dtype)
        side = torch.where(vals > 0, qz._c(rmax, vals), qz._c(rmin, vals))
        recip = 1.0 / torch.tensor(qz.qt_denom(cfg, vals.dtype), dtype=vals.dtype)
        return (vals - side) * (qtable.to(vals.dtype)[None, :] * recip)

    monkeypatch.setattr(qz, "qt_inverse", qt_inverse)


def use_ref_arithmetic(monkeypatch) -> None:
    """Two float operations of the port set to the reference's as XLA
    compiles them on the CPU, so that whole containers compare byte for
    byte; every other operation of the port stays its own.

    - The block transforms (core/transform.block_dct and block_idct, which
      every CPU route reaches) run the reference's jitted products on the
      same inputs: the two packages' matmuls add their products in other
      orders, a budget held apart (test_torch_core.py, test_torch_f64.py).
    - The QT renormalization ((c / q) * eb) * qt_factor + side: XLA folds
      the two constant factors into one and fuses the product with the add
      (one rounding) in the reference's jitted chain and in its Pallas
      kernels run in interpret mode, where the operands are compile-time
      constants; the kernels on a TPU, and the port's kernels and torch
      ops, round each operation (the C codec's order)."""
    import jax.numpy as jnp

    from dctz_tpu.core import transform as jt
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.core import transform as tt

    # jitted, as the reference's chain runs them: an eager product of one
    # row (a partial last block) adds in another order than the compiled one
    fwd = {p: jax.jit(lambda b, p=p: jt.block_dct(b, precision=jt.prec_of(p)))
           for p in ("highest", "high")}
    inv = jax.jit(jt.block_idct)

    def block_dct(blocks, precision="highest"):
        return torch.from_numpy(np.array(fwd[precision](jnp.asarray(blocks.numpy()))))

    def block_idct(coeffs):
        return torch.from_numpy(np.array(inv(jnp.asarray(coeffs.numpy()))))

    def qt_renorm(coeffs, qtable, cfg):
        _, rmin, rmax = qz._geometry(cfg, coeffs.dtype)
        side = torch.where(coeffs > 0, qz._c(rmax, coeffs), qz._c(rmin, coeffs))
        q = qtable.to(coeffs.dtype)[None, :]
        return _fma(coeffs / q, qz.qt_denom(cfg, coeffs.dtype), side)

    monkeypatch.setattr(tt, "block_dct", block_dct)
    monkeypatch.setattr(tt, "block_idct", block_idct)
    monkeypatch.setattr(qz, "qt_renorm", qt_renorm)


def _two_sum(p: torch.Tensor, c: torch.Tensor):
    """(s, e): s = p + c rounded, e its exact error (Knuth's TwoSum)."""
    s = p + c
    bb = s - p
    return s, (p - (s - bb)) + (c - bb)


def _fma(a: torch.Tensor, k: float, c: torch.Tensor) -> torch.Tensor:
    """a * k + c rounded once (a fused multiply-add), for float32 or float64
    tensors a and c and a constant k of their dtype, in plain IEEE
    operations on the CPU. Float32: the product is exact in doubles and
    the double sum, rounded to odd, rounds correctly to float32. Float64:
    the product's error comes exact from Veltkamp splitting, the sum's from
    TwoSum, and both are added back in one last rounding (exact but where
    that last small sum itself rounds)."""
    if a.dtype == torch.float32:
        s, err = _two_sum(a.to(torch.float64) * k, c.to(torch.float64))
        even = (s.view(torch.int64) & 1) == 0
        s = torch.where((err != 0) & even, torch.nextafter(s, s + err), s)
        return s.to(torch.float32)
    split = 134217729.0  # 2**27 + 1

    def halves(v):
        t = v * split
        hi = t - (t - v)
        return hi, v - hi

    kt = torch.tensor(k, dtype=a.dtype, device=a.device)
    p = a * kt
    a_hi, a_lo = halves(a)
    k_hi, k_lo = halves(kt)
    e_p = ((a_hi * k_hi - p) + a_hi * k_lo + a_lo * k_hi) + a_lo * k_lo
    s, e_s = _two_sum(p, c)
    return s + (e_p + e_s)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the calls of every kernel wrapper (on the CPU each runs its
    plain version), by kernel letter: A dct_quant_verify, B
    dpk_pack_compact, C dpk_unpack_expand, D dequant_idct, E qtable_qmax,
    F/G dct_quant, H compact_f32, I expand, J compact_unified; "H64" and
    "I64" count the calls of H and I given float64 values."""
    from dctz_tpu_torch.ops import dpk_fuse, fused_encode, shuffle

    calls: dict = {}
    wrappers = {"A": (dpk_fuse, "dct_quant_verify"),
                "B": (dpk_fuse, "dpk_pack_compact"),
                "C": (dpk_fuse, "dpk_unpack_expand"),
                "D": (dpk_fuse, "dequant_idct"),
                "E": (fused_encode, "qtable_qmax"),
                "FG": (fused_encode, "dct_quant"),
                "H": (shuffle, "compact_f32"),
                "I": (shuffle, "expand"),
                "J": (shuffle, "compact_unified")}

    def counted(letter, fn):
        def call(*args, **kw):
            calls[letter] = calls.get(letter, 0) + 1
            if any(isinstance(a, torch.Tensor) and a.dtype == torch.float64
                   for a in args):
                calls[letter + "64"] = calls.get(letter + "64", 0) + 1
            return fn(*args, **kw)
        return call

    for letter, (mod, name) in wrappers.items():
        monkeypatch.setattr(mod, name, counted(letter, getattr(mod, name)))
    return calls
