"""The CUDA kernels against their plain versions on the card, at small and
edge shapes (partial tiles, the overflow retry's capacity, the chunk width
of short containers). chip_smoke.py checks the main path's shapes.

These tests need an NVIDIA GPU and nvcc; they skip elsewhere. On the card,
without jax installed (tests/conftest.py imports it), run them with

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TILE_N = 16384


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _signal(n, seed, narrow=False):
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32)
    x = np.sin(t * np.float32(0.003)) * np.float32(30.0) + rng.standard_normal(n).astype(np.float32)
    if narrow:  # repair has work in many blocks
        x = np.float32(11.0) + x * np.float32(0.02)
    return x.astype(np.float32)


def _ids(rng, nblk, esc_p):
    mag = rng.geometric(p=0.4, size=(nblk, 64)).astype(np.int64) - 1
    ids = np.minimum(mag * 8 // np.maximum(1, np.arange(64) // 4)[None, :], 254)
    ids = np.where(rng.random((nblk, 64)) < esc_p, 255, ids)
    ids[:, 0] = 255
    return ids.astype(np.uint8), rng.standard_normal((nblk, 64)).astype(np.float32)


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("n_valid", [2 * TILE_N, 5 * TILE_N - 11])
def test_kernel_a(dev, verify, n_valid):
    from dctz_tpu_torch import api
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode

    x = torch.from_numpy(_signal(n_valid, n_valid, narrow=verify)).to(dev)
    n_pad = n_valid + (-n_valid) % 1024
    xp = torch.nn.functional.pad(x, (0, n_pad - n_valid))
    sf, _ = api._stats_device(xp, n_valid, 1)
    tol = fused_encode.tolerance(xp, n_valid, 1e-3)
    ik, ck, okk = fk.dct_quant_verify(xp, sf, tol, n_valid, 1e-3, verify)
    ip, cp_, okp = fk._dct_quant_verify_plain(xp, sf, tol, n_valid,
                                              CodecConfig(error_bound=1e-3), verify)
    assert (ik != ip).float().mean().item() <= 1e-4
    assert bool(okk) == bool(okp)
    xs = (xp / sf).reshape(-1, 64)
    assert torch.all((ck - cp_).abs() <= 32 * 2.0**-23 * xs.abs().amax(1, keepdim=True))


@pytest.mark.parametrize("nblk,esc_p,cape", [(256, 0.02, 128), (4096 + 128, 0.02, 128),
                                             (512, 0.35, 128), (512, 0.35, 512)])
def test_kernel_b_byte_equal(dev, nblk, esc_p, cape):
    from dctz_tpu_torch.ops import dpk_fuse as fk

    ids, vals = _ids(np.random.default_rng(nblk), nblk, esc_p)
    it, vt = torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev)
    got = fk.dpk_pack_compact(it, vt, nblk * 64 - 7, cape, 512)
    ref = fk._dpk_pack_compact_plain(it, vt, nblk * 64 - 7, cape)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("n", [5 * TILE_N - 11, 7777, 3 * TILE_N, "golden_v2_ec_f32_dpk_legacyzstd"])
def test_kernels_c_d_match_plain(dev, n):
    """Decode of port containers and of a committed JAX-package container
    whose chunk width is 128 and whose last block is partial (its zlib-only
    variant: the card's host may lack the zstandard package)."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import container as ct
    from dctz_tpu_torch.ops import dpk_fuse as fk

    cfg = dz.CodecConfig(container="v2", ids_codec="device", verify=True, segment_elems=0)
    if isinstance(n, str):
        import pathlib

        blob = (pathlib.Path(__file__).parent / "golden" / f"{n}.z").read_bytes()
    else:
        blob = dz.compress(_signal(n, n), config=cfg, device="cpu")
    header, streams, _q, _cb = ct.parse_v2(blob)
    (width, rows, exc, dc, ac), (n_stream, _tb, cw, hcfg) = api._dpk_decode_prep(header, streams)
    d_in = [torch.from_numpy(np.array(a)).to(dev) for a in (width, rows, exc)]
    dc_d = api._combine_planes(torch.from_numpy(np.array(dc)).to(dev))
    ac_d = api._combine_planes(torch.from_numpy(np.array(ac)).to(dev)).contiguous()
    nblk = -(-n_stream // 64)
    ik, ak = fk.dpk_unpack_expand(*d_in, ac_d, nblk, n_stream, cw)
    ip, ap = fk._dpk_unpack_expand_plain(*d_in, ac_d, nblk, n_stream, cw)
    assert torch.equal(ik, ip) and torch.equal(ak.view(torch.int32), ap.view(torch.int32))
    sf = torch.tensor(header.scaling_factor, dtype=torch.float32, device=dev)
    fk.reset_launches()
    xk = fk.dequant_idct(ik, ak, dc_d, sf, hcfg, n_stream)[:n_stream]
    assert fk.LAUNCHES["dequant_idct"] == 1
    xp = fk._dequant_idct_plain(ik, ak, dc_d, sf, hcfg, n_stream)[:n_stream]
    assert (xk - xp).abs().max().item() <= 32 * 2.0**-23 * header.scaling_factor


def test_partial_last_block_decodes_in_kernel(dev):
    """A committed JAX-package container that stores its true length decodes
    on the card through C and D alone, to the plain decode within 32 ulp."""
    import pathlib

    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import container as ct
    from dctz_tpu_torch.ops import dpk_fuse as fk

    blob = (pathlib.Path(__file__).parent / "golden"
            / "golden_v2_ec_f32_dpk_legacyzstd.z").read_bytes()
    header = ct.parse_v2(blob)[0]
    fk.reset_launches()
    got = dz.decompress(blob, device="cuda")
    assert fk.LAUNCHES == {"dct_quant_verify": 0, "dpk_pack_compact": 0,
                           "dpk_unpack_expand": 1, "dequant_idct": 1}
    ref = dz.decompress(blob, device="cpu")
    assert got.shape == ref.shape and header.num_elements % 64
    assert np.abs(got - ref).max() <= 32 * 2.0**-23 * header.scaling_factor


@pytest.mark.parametrize("n", [5 * TILE_N - 11, 7777])
def test_round_trip_on_card(dev, n):
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.ops import dpk_fuse as fk

    cfg = dz.CodecConfig(container="v2", ids_codec="device", verify=True, segment_elems=0)
    x = _signal(n, n + 1)
    fk.reset_launches()
    blob = dz.compress(x, config=cfg, device="cuda")
    y = dz.decompress(blob, device="cuda")
    assert all(v > 0 for v in fk.LAUNCHES.values())
    assert dz.evaluate(x, y, 1e-3)["bound_satisfied"]
    blob_cpu = dz.compress(x, config=cfg, device="cpu")
    assert abs(len(blob) / len(blob_cpu) - 1.0) <= 1e-3
    assert np.abs(dz.decompress(blob_cpu, device="cuda") - x).max() <= 1e-3 * float(x.max() - x.min())
