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

torch.set_num_threads(2)

EB = 1e-3
EPS32 = 2.0 ** -23
TILE_N = 16384
#: the headers' mean, a float32 sum divided by n, agrees within MEAN_ULPS
#: ulp of the mean |x|: XLA and torch add the float32 samples in other
#: orders, and the rounding of a reordered sum scales with the summands'
#: magnitudes, not with the (cancelling) total
MEAN_ULPS = 4


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


def assert_mean_close(h_port, h_ref, x: np.ndarray) -> None:
    """The headers' means within MEAN_ULPS ulp of float32(mean |x|)."""
    lim = MEAN_ULPS * float(np.spacing(np.float32(np.abs(x).mean())))
    assert abs(h_port.mean - h_ref.mean) <= lim, (h_port.mean, h_ref.mean, lim)


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
