"""The port's sharded paths (dctz_tpu_torch.parallel.sharding, api
compress_sharded / decompress_sharded) against dctz_tpu's on the CPU: the
reference on a JAX mesh of jax.devices()[:k] (tests/conftest.py's virtual
host devices), the port on the mesh ["cpu"] * k, k in {2, 4}.

Containers byte for byte but for the header's mean (a float32 sum in
another order, within MEAN_ULPS; float64 means are not compared), QT's
qtable slot 0 included (the MAX of the shards' last-block DCs); the DPK
frames of the fused body may differ by a bin-edge flip of the Pallas
kernel's own transform (test_torch_oracle.assert_byte_equal's
edge_flips). Decodes bit-equal to the reference's sharded decode and to the
port's own decompress, under test_torch_oracle.ref_arithmetic and
ref_inverse.

Float64 runs first, with x64 on as tests/conftest.py leaves it (the
reference's float64 configuration: full width); float32 runs last, under
the module-scoped `oracle` fixture (x64 off, the fused dispatch forced).
"""

import numpy as np
import pytest
import torch

import jax

from test_torch_oracle import (  # noqa: F401
    TILE_N, assert_byte_equal, bound, oracle, ref_arithmetic, ref_inverse, signal,
)

torch.set_num_threads(2)

EB = 1e-3


def _meshes(k):
    from dctz_tpu.parallel import sharding as jsh

    return jsh.make_mesh(jax.devices()[:k]), ["cpu"] * k


def _cfgs(**kw):
    import dctz_tpu
    import dctz_tpu_torch as dz

    base = dict(error_bound=EB, container="v2", verify=True)
    base.update(kw)
    return dctz_tpu.CodecConfig(**base), dz.CodecConfig(**base)


def _both(x, k, **kw):
    """(port container, reference container) of compress_sharded."""
    from dctz_tpu import api as ja
    import dctz_tpu_torch as dz

    jm, tm = _meshes(k)
    jc, tc = _cfgs(**kw)
    return dz.compress_sharded(x, config=tc, mesh=tm), ja.compress_sharded(x, config=jc, mesh=jm)


def test_padded_size_matches_reference():
    from dctz_tpu.parallel import sharding as jsh
    from dctz_tpu_torch.parallel import sharding as sh

    assert sh.padded_size(1, 8, 64) == 512
    assert sh.padded_size(512, 8, 64) == 512
    assert sh.padded_size(513, 8, 64) == 1024
    for args in [(1, 8, 64), (12345, 4, 64, 256), (65536, 2, 128, 256), (7, 3, 48)]:
        assert sh.padded_size(*args) == jsh.padded_size(*args)


def test_mesh_of_a_device():
    from dctz_tpu_torch.parallel import sharding as sh

    assert sh.mesh_for(None, "cpu") == [torch.device("cpu")]
    assert sh.mesh_for(["cpu", "cpu"], "cuda") == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sh.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            sh.mesh_for(None, "cuda")


@pytest.mark.parametrize("nblk,n_valid,cw", [(256, 256 * 64, 512), (512, 512 * 64 - 700, 512),
                                             (260, 260 * 64, 256), (64, 50 * 64 + 3, 128)])
def test_ac_chunk_counts_matches_reference(nblk, n_valid, cw):
    import jax.numpy as jnp

    from dctz_tpu.ops import idpack as ji
    from dctz_tpu_torch.ops import idpack as ti
    from test_torch_oracle import id_stream

    ids, _vals = id_stream(np.random.default_rng(nblk), nblk, esc_p=0.05)
    ref = np.asarray(ji.ac_chunk_counts(jnp.asarray(ids), n_valid, cw))
    got = ti.ac_chunk_counts(torch.from_numpy(ids), n_valid, cw)
    assert got.dtype == torch.int32 and got.numpy().tobytes() == ref.tobytes()


# ---------------------------------------------------------------------------
# float64: x64 on, the reference's full-width configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,codec", [("ec", "device"), ("qt", "device"),
                                        ("ec", "deflate"), ("qt", "deflate")])
def test_f64_matches_reference(ref_arithmetic, ref_inverse, mode, codec):
    """Float64 at full width on k = 2: the chain body in float64, the
    reference's global compaction layout against the port's chunked one
    (the container does not record it). tests/test_torch_f64.py's rules,
    and both sharded decodes within 8 eps64 * max|y| of each other."""
    import dctz_tpu_torch as dz
    from dctz_tpu import api as ja
    from test_torch_f64 import EPS64, assert_same_container, signal64

    n = 2 * TILE_N + 555 if codec == "device" else 64 * 2 * 41 + 9
    x = signal64(n, 7)
    port, ref = _both(x, 2, mode=mode, ids_codec=codec)
    assert_same_container(port, ref)
    jm, tm = _meshes(2)
    y = dz.decompress_sharded(port, mesh=tm)
    want = np.asarray(ja.decompress_sharded(ref, mesh=jm))
    assert y.dtype == want.dtype == np.float64 and y.shape == x.shape
    assert np.abs(y - want).max() <= 8 * EPS64 * np.abs(want).max()
    assert np.array_equal(y, dz.decompress(port, device="cpu"))
    assert np.abs(y - x).max() <= EB * float(x.max() - x.min())


# ---------------------------------------------------------------------------
# float32 under the oracle (x64 off from here to the end of the module)
# ---------------------------------------------------------------------------

#: (k, n): a last shard holding padding, and a last shard of padding only
#: (the DPK quantum is k tiles of 256 blocks; the host-coded one k blocks:
#: 550 samples on 4 shards of 3 blocks, the last all padding). Shards of one
#: block are left out: the reference's decode compiles a one-row inverse
#: product that adds in another order than ref_arithmetic's
DPK_LENGTHS = [(2, 2 * TILE_N * 2 - 777), (4, 3 * TILE_N - 100), (4, 4 * TILE_N - 5)]
HOST_LENGTHS = [(2, 64 * 2 * 37 + 11), (4, 550)]


def _decodes(x, port, ref, k):
    """decompress_sharded of the port's container equal to the reference's
    decompress_sharded and to the port's decompress; each package decodes
    the other's container within the bound."""
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu import api as ja

    jm, tm = _meshes(k)
    y = dz.decompress_sharded(port, mesh=tm)
    assert y.dtype == np.float32 and y.shape == x.shape
    assert np.array_equal(y, np.asarray(ja.decompress_sharded(port, mesh=jm)))
    assert np.array_equal(y, dz.decompress(port, device="cpu"))
    for got in (y, dz.decompress(ref, device="cpu"), dz.decompress_sharded(ref, mesh=tm),
                np.asarray(dctz_tpu.decompress(port))):
        assert np.abs(got - x).max() <= bound(x)


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("k,n", DPK_LENGTHS)
def test_dpk_matches_reference(oracle, ref_arithmetic, ref_inverse, mode, k, n):
    """DPK ids: EC takes the fused body (kernels A + B per shard), QT the
    chain (its qtable slot 0 the MAX of the shards' last-block DCs). Both
    may flip a bin edge: the fused body's reference is the Pallas kernel's
    own transform, and the chain's reference computes its transform inside
    the shard_map program, whose compiled product may round a coefficient
    an ulp away from the standalone jitted product of ref_arithmetic."""
    x = signal(n, n + k)
    port, ref = _both(x, k, mode=mode, ids_codec="device")
    assert_byte_equal(port, ref, x, edge_flips=True)
    _decodes(x, port, ref, k)


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("k,n", HOST_LENGTHS)
def test_host_coded_matches_reference(oracle, ref_arithmetic, ref_inverse, mode, k, n):
    """Host-coded ids (deflate): the chain body, its id stream of the
    padded length."""
    x = signal(n, n + k)
    port, ref = _both(x, k, mode=mode, ids_codec="deflate")
    assert_byte_equal(port, ref, x)
    _decodes(x, port, ref, k)


def test_ec_equals_single_device_container(oracle):
    """With no padding, the sharded EC container is the single-device
    container but for the mean: the shards' tile- and chunk-major outputs
    in mesh order are the single-device layout."""
    import dctz_tpu_torch as dz
    from test_torch_oracle import assert_mean_close
    from dctz_tpu_torch.core import container as ct

    x = signal(4 * TILE_N, 11)
    cfg = dz.CodecConfig(error_bound=EB, container="v2", verify=True, segment_elems=0)
    mono = dz.compress(x, config=cfg, device="cpu")
    shard = dz.compress_sharded(x, config=cfg, mesh=["cpu"] * 4)
    hm, sm, _ = ct.parse_v2(mono)[:3]
    hs, ss, _ = ct.parse_v2(shard)[:3]
    assert sm == ss
    assert_mean_close(hs, hm, x)
    assert np.array_equal(dz.decompress_sharded(shard, mesh=["cpu"] * 4),
                          dz.decompress(mono, device="cpu"))


def test_internal_float32_matches_reference(oracle, ref_arithmetic):
    """internal_dtype="float32": float64 input cast, the fused body, a
    float64 header."""
    x = signal(2 * TILE_N - 300, 4).astype(np.float64)
    port, ref = _both(x, 2, internal_dtype="float32", ids_codec="device")
    assert_byte_equal(port, ref, x.astype(np.float32), edge_flips=True)


def test_tensor_input_is_split_where_it_lies(oracle, monkeypatch):
    """A tensor is padded and split on its own device (no numpy round
    trip: Tensor.numpy raises during the split), and writes the numpy
    input's container."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.parallel import sharding as sh

    x = signal(2 * TILE_N + 1000, 5)
    cfg = dz.CodecConfig(error_bound=EB, container="v2", verify=True)
    blob_np = dz.compress_sharded(x, config=cfg, mesh=["cpu"] * 2)
    orig = sh.shard_input_device

    def guarded(*a, **kw):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.Tensor, "numpy", lambda *_a, **_k: pytest.fail("host copy"))
            return orig(*a, **kw)

    monkeypatch.setattr(sh, "shard_input_device", guarded)
    assert dz.compress_sharded(torch.from_numpy(x), config=cfg, mesh=["cpu"] * 2) == blob_np
    shards, n_pad = orig(torch.from_numpy(x).reshape(2, -1), ["cpu"] * 2, 64, 256)
    assert n_pad == 4 * TILE_N and [s.shape[0] for s in shards] == [2 * TILE_N] * 2
    promoted, _ = orig(torch.from_numpy(x.astype(np.float64)), ["cpu"] * 2, 64,
                       promote_f32=True)
    assert promoted[0].dtype == torch.float32


def test_dtzs_and_true_length_streams_decode(oracle):
    """decompress_sharded of a DTZS stream restores frame by frame into one
    output, and of a host-coded container whose id stream ends mid-block
    (the generic chain's rem-point tail) decodes on the single-device path:
    both equal decompress."""
    import dctz_tpu_torch as dz

    x = signal(3 * 4096 + 37, 6)
    for kw in (dict(segment_elems=4096), dict(container="v1"),
               dict(ids_codec="deflate", block_size=32, segment_elems=0)):
        cfg = dz.CodecConfig(error_bound=EB, verify=True, **dict(dict(container="v2"), **kw))
        blob = dz.compress(x, config=cfg, device="cpu")
        if kw.get("container") == "v1":
            with pytest.raises(ValueError):
                dz.decompress_sharded(blob, mesh=["cpu"] * 2)
            continue
        y = dz.decompress_sharded(blob, mesh=["cpu"] * 3)
        assert np.array_equal(y, dz.decompress(blob, device="cpu"))
        assert np.abs(y - x).max() <= bound(x)
