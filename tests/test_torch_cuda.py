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
EC_KERNELS = {"dct_quant_verify", "dpk_pack_compact", "dpk_unpack_expand",
              "dequant_idct"}
QT_KERNELS = {"qtable_qmax", "dct_quant_verify_qt", "dpk_pack_compact",
              "dpk_unpack_expand", "dequant_idct_qt"}


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


def _grid(nblk, esc_p, kind, seed):
    """An id grid and its values: "ids" (_ids), "zero" (every id 0 but the
    DC column, so every width is 0), "w3" (positions 1-24 uniform in 0..6,
    which makes their width 3, the rest as "ids"), "tiles" (tile 0 as
    "ids", tile 1 all zero, the rest "w3")."""
    rng = np.random.default_rng(seed)
    ids, vals = _ids(rng, nblk, esc_p)
    w3 = ids.copy()
    w3[:, 1:25] = rng.integers(0, 7, size=(nblk, 24))
    if kind == "zero":
        ids[:, 1:] = 0
    elif kind == "w3":
        ids = w3
    elif kind == "tiles":
        ids = np.concatenate([ids[:256], np.zeros_like(ids[256:512]), w3[512:]])
        ids[:, 0] = 255
    return ids, vals


#: (nblk, esc_p, cape, cw, kind, n_valid short of nblk * 64): cw 64-512,
#: partial last tiles with n_valid inside a block, rows that overflow
#: cape = 128 and the cape = cw retry, all-zero tiles and width-3 rows
B_CASES = [(256, 0.02, 128, 512, "ids", 7), (4096 + 128, 0.02, 128, 512, "ids", 7),
           (512, 0.35, 128, 512, "ids", 7), (512, 0.35, 512, 512, "ids", 7),
           (296, 0.02, 64, 64, "ids", 7), (296, 0.05, 128, 128, "w3", 77),
           (296, 0.35, 256, 256, "ids", 7), (296, 0.35, 128, 256, "ids", 130),
           (296, 0.0, 128, 512, "zero", 7), (768 + 40, 0.03, 128, 512, "tiles", 3)]


@pytest.mark.parametrize("nblk,esc_p,cape,cw,kind,short", B_CASES)
def test_kernel_b_byte_equal(dev, nblk, esc_p, cape, cw, kind, short):
    from dctz_tpu_torch.ops import dpk_fuse as fk

    ids, vals = _grid(nblk, esc_p, kind, nblk)
    it, vt = torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev)
    fk.reset_launches()
    got = fk.dpk_pack_compact(it, vt, nblk * 64 - short, cape, cw)
    assert fk.LAUNCHES["dpk_pack_compact"] == 1
    ref = _pack_plain_at(it, vt, nblk * 64 - short, cape, cw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    if kind == "w3":  # the full tiles
        assert bool((got[0][: nblk // 256, 1:25] == 3).all())
    if kind in ("zero", "tiles"):
        assert bool((got[0][1 if kind == "tiles" else 0] == 0).all())
    if esc_p == 0.35 and cw == 512:
        assert int(got[3].max()) > 128


def _pack_plain_at(ids, vals, n_valid, cape, cw):
    """Kernel B's plain version at chunk width cw."""
    from dctz_tpu_torch.ops import dpk_fuse as fk

    return fk._dpk_pack_compact_plain(ids, vals, n_valid, cape, cw)


#: synthetic decode inputs (nblk, cw, esc_p, kind, cape, capc): every decode
#: tier at cw 512 (32, 64 and 128 staged in shared memory; 256 and cw read
#: from device memory), the staged and wide instantiations at cw 64-256,
#: all-zero and width-3 tiles; n_stream ends inside the last block
C_CASES = [(296, 512, 0.02, "ids", 32, 32), (296, 512, 0.02, "tiles", 64, 32),
           (296, 512, 0.35, "ids", 128, 64), (296, 512, 0.35, "ids", 256, 128),
           (296, 512, 0.35, "ids", 512, 512), (296, 256, 0.05, "w3", 64, 64),
           (296, 128, 0.02, "ids", 32, 32), (296, 128, 0.05, "ids", 128, 32),
           (296, 64, 0.02, "ids", 32, 32), (296, 64, 0.05, "ids", 64, 64),
           (296, 512, 0.0, "zero", 128, 32)]


def _synthetic_decode(dev, nblk, cw, esc_p, kind, cape, capc):
    """B's plain streams of a _grid at full capacity, rows cut to (cape,
    capc): (width, packed, exc, dc, ac, n_stream)."""
    ids, vals = _grid(nblk, esc_p, kind, nblk + cw)
    it, vt = torch.from_numpy(ids), torch.from_numpy(vals)
    w, pk, exc, _ec, ac, _acn, dc = _pack_plain_at(it, vt, nblk * 64, cw, cw)
    return ([a.contiguous().to(dev) for a in (w, pk, exc[:, :cape], dc, ac[:, :capc])],
            nblk * 64 - 9)


@pytest.mark.parametrize("n", [5 * TILE_N - 11, 7777, 3 * TILE_N, "golden_v2_ec_f32_dpk_legacyzstd",
                               *C_CASES])
def test_kernels_c_d_match_plain(dev, n):
    """Decode of port containers, of a committed JAX-package container
    whose chunk width is 128 and whose last block is partial (its zlib-only
    variant: the card's host may lack the zstandard package), and of
    synthetic streams at every decode tier and chunk width (C_CASES)."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import container as ct
    from dctz_tpu_torch.ops import dpk_fuse as fk

    cfg = dz.CodecConfig(container="v2", ids_codec="device", verify=True, segment_elems=0)
    if isinstance(n, tuple):
        (w, pk, exc, dc_d, ac_d), n_stream = _synthetic_decode(dev, *n)
        d_in, cw, hcfg, sf_v = [w, pk, exc], n[1], dz.CodecConfig(error_bound=1e-3), 3.0
        synthetic = True
    else:
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
        sf_v, synthetic = header.scaling_factor, False
    nblk = -(-n_stream // 64)
    fk.reset_launches()
    ik, ak = fk.dpk_unpack_expand(*d_in, ac_d, nblk, n_stream, cw)
    assert fk.LAUNCHES["dpk_unpack_expand"] == 1
    ip, ap = fk._dpk_unpack_expand_plain(*d_in, ac_d, nblk, n_stream, cw)
    assert torch.equal(ik, ip) and torch.equal(ak.view(torch.int32), ap.view(torch.int32))
    sf = torch.tensor(sf_v, dtype=torch.float32, device=dev)
    fk.reset_launches()
    xk = fk.dequant_idct(ik, ak, dc_d, sf, hcfg, n_stream)[:n_stream]
    assert fk.LAUNCHES["dequant_idct"] == 1
    xp = fk._dequant_idct_plain(ik, ak, dc_d, sf, hcfg, n_stream)[:n_stream]
    if not synthetic:
        assert (xk - xp).abs().max().item() <= 32 * 2.0**-23 * sf_v
    else:  # 32 ulp of sf times the block's largest coefficient (at least 1)
        from dctz_tpu_torch.core import quantize as qz

        co = qz.decode_dense(ik, dc_d, ak, nblk * 64, hcfg)
        lim = (32 * 2.0**-23 * sf_v * co.abs().amax(1).clamp_min(1.0)).repeat_interleave(64)
        assert torch.all((xk - xp).abs() <= lim[:n_stream])


def test_kernel_b_equals_l(dev):
    """On the bench array, B on kernel A's output (verify off; A equals F
    bit for bit) gives L_ref's width, packed, exception rows, exception
    counts and DC, and its AC streams too where no chunk row holds more than
    128 exceptions. L_ref, the card-only reference, keeps the per-byte
    stages of dpk_tile.cuh (L shares B's)."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode as fe
    from dctz_tpu_torch.ops.research import _ref

    n = 5 * TILE_N - 1024
    x = torch.from_numpy(_bench(n)).to(dev)
    sf, _ = api._stats_device(x, n, 1)
    ids, vals, _ok = fk.dct_quant_verify(x, sf, fe.tolerance(x, n, 1e-3), n, 1e-3, False)
    got = fk.dpk_pack_compact(ids, vals, n, 128, 512)
    ref = _ref.fused_encode_dpk_ref(x, sf, 1e-3)
    for i in (0, 1, 2, 3):
        assert torch.equal(got[i], ref[i]), i
    assert bool((got[6] == ref[6]).all())
    if int(got[3].max()) <= 128:
        assert torch.equal(got[4], ref[4]) and torch.equal(got[5], ref[5])


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
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
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
    assert {k for k, v in fk.LAUNCHES.items() if v} == EC_KERNELS
    assert dz.evaluate(x, y, 1e-3)["bound_satisfied"]
    blob_cpu = dz.compress(x, config=cfg, device="cpu")
    assert abs(len(blob) / len(blob_cpu) - 1.0) <= 1e-3
    assert np.abs(dz.decompress(blob_cpu, device="cuda") - x).max() <= 1e-3 * float(x.max() - x.min())


def _qt_input(n, seed):
    """A climate-like signal with every 977th sample x30, so that the
    qtable has entries > 1."""
    x = _signal(n, seed)
    x[::977] *= np.float32(30.0)
    return x


def _padded_on(dev, x):
    n = x.size
    return torch.nn.functional.pad(torch.from_numpy(x).to(dev), (0, (-n) % 1024))


CTA_N = 64 * 64  # samples per CUDA block tile of kernels A, D, E, F and G
#: lengths whose 1024-padding leaves the last 64-block tile partial
TILE_EDGES = [5 * 1024, 5 * 1024 - 11, 3 * CTA_N + 2048 - 11]
ONE_K = 37  # the position where every block of the "one_position" input escapes


def _one_position(n, seed):
    """_signal plus, in every block, the basis row of position ONE_K at a
    random amplitude: most blocks escape at that one position, so E's
    running maxima there meet in its shuffle, warp and CTA folds."""
    from dctz_tpu_torch.core import transform

    rng = np.random.default_rng(seed)
    nb = -(-n // 64)
    amp = (rng.random(nb) * 20.0 + 1.0).astype(np.float32)
    row = transform.dct2_basis(64, "cpu").numpy()[ONE_K]
    return (_signal(n, seed) + (amp[:, None] * row[None, :]).reshape(-1)[:n]).astype(np.float32)


def _off16(xp):
    """xp's values in a view that starts 4 bytes past a 16-byte boundary (a
    view at a multiple of 4 elements, such as x[1024:], is aligned); the
    wrappers copy it (dpk_fuse._aligned16) before the kernels' 16-byte
    loads."""
    base = torch.empty(xp.numel() + 1, dtype=xp.dtype, device=xp.device)
    base[1:] = xp
    view = base[1:]
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("n,kind", [(3 * 1024, "x30"), (5 * TILE_N - 11, "x30")]
                         + [(n, "x30") for n in TILE_EDGES]
                         + [(40 * CTA_N + 1024, "one_position"),
                            (5 * TILE_N - 11, "misaligned")])
def test_kernel_e_matches_plain(dev, n, kind):
    """E's maxima are taken over the coefficients kernel A computes: bit-equal
    to the clamped max over A-EC's own output, within 4 ulp of the plain
    version (a torch matmul). On the x30 input, where every escape position
    folds across many blocks ("one_position"), and on a misaligned view.
    The plain version runs on the CPU copy of the input: its sums follow the
    kernel's fmaf order there, which the card's matmul does not."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode as fe

    xp = _padded_on(dev, _one_position(n, n) if kind == "one_position" else _qt_input(n, n))
    sf, _ = api._stats_device(xp, n, 1)
    fk.reset_launches()
    got = fe.qtable_qmax(_off16(xp) if kind == "misaligned" else xp, sf, 1e-3)
    assert fk.LAUNCHES["qtable_qmax"] == 1
    if kind == "one_position":
        assert torch.argmax(got).item() == ONE_K and got[ONE_K].item() > 1.0
    # the plain version on the CPU, whose float32 sums follow the kernel's
    # fmaf order (the card's matmul sums in another order)
    plain = fe._qtable_qmax_plain(xp.cpu(), sf.cpu(), CodecConfig(mode="qt", error_bound=1e-3))
    plain = torch.clamp_min(plain, 1.0)
    got_c = got.cpu()
    ulps = (got_c - plain).abs() / torch.maximum(got_c, plain) * 2.0**23
    assert ulps.max().item() <= 4
    from dctz_tpu_torch.core import quantize as qz

    _ids, coef, _ok = fk.dct_quant_verify(xp, sf, sf, n, 1e-3, False)
    _w, rmin, rmax = qz._geometry(CodecConfig(error_bound=1e-3))
    esc = ~((coef >= rmin) & (coef <= rmax)) & (torch.arange(64, device=dev) > 0)
    from_a = torch.where(esc, coef.abs(), torch.zeros_like(coef)).amax(0)
    assert torch.equal(got, torch.clamp_min(from_a, 1.0))


def _qtable(dev, xp, sf):
    from dctz_tpu_torch.ops import fused_encode as fe

    q = fe.qtable_qmax(xp, sf, 1e-3)
    assert (q[1:] > 1.0).any()
    return q


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("n_valid", [2 * TILE_N, 5 * TILE_N - 11])
def test_kernel_a_qt(dev, verify, n_valid):
    """A-QT against its plain version: ids within 1e-4, the same verified
    flag, coefficients within 32 ulp of max|x/sf| of their block, stored
    escapes within that times eb*qt_factor/q[k] plus 4 ulp."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode

    xp = _padded_on(dev, _qt_input(n_valid, n_valid + 1))
    sf, _ = api._stats_device(xp, n_valid, 1)
    if verify:  # a tighter sf: repair has work in many blocks
        sf = sf / 100
    q = _qtable(dev, xp, sf)
    tol = fused_encode.tolerance(xp, n_valid, 1e-3)
    fk.reset_launches()
    ik, vk, okk = fk.dct_quant_verify(xp, sf, tol, n_valid, 1e-3, verify, q)
    assert fk.LAUNCHES["dct_quant_verify_qt"] == 1
    cfg = CodecConfig(mode="qt", error_bound=1e-3)
    ip, vp, okp = fk._dct_quant_verify_plain(xp, sf, tol, n_valid, cfg, verify, q)
    assert (ik != ip).float().mean().item() <= 1e-4
    assert bool(okk) == bool(okp)
    budget = 32 * 2.0**-23 * (xp / sf).reshape(-1, 64).abs().amax(1, keepdim=True)
    esc = (ik == ip) & (ik == 255) & (torch.arange(64, device=dev) > 0)
    assert esc.sum().item() > 0
    lim = torch.where(esc, budget * 1e-2 / q + 4 * 2.0**-23 * vp.abs(),
                      budget.expand_as(vp))
    same = ik == ip
    assert torch.all(((vk - vp).abs() <= lim)[same])


def _decode_inputs(dev, blob):
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import container as ct

    header, streams, qtable, _cb = ct.parse_v2(blob)
    (width, rows, exc, dc, ac), (n_stream, _tb, cw, hcfg) = api._dpk_decode_prep(header, streams)
    d_in = [torch.from_numpy(np.array(a)).to(dev) for a in (width, rows, exc)]
    dc_d = api._combine_planes(torch.from_numpy(np.array(dc)).to(dev))
    ac_d = api._combine_planes(torch.from_numpy(np.array(ac)).to(dev)).contiguous()
    if header.dcd:
        dc_d = api._f32_delta_inv_dev(dc_d)
    q = torch.from_numpy(qtable.astype(np.float32)).to(dev)
    return header, d_in, dc_d, ac_d, q, n_stream, cw, hcfg


@pytest.mark.parametrize("src", [5 * TILE_N - 11, "golden_v2_qt_f32_dpk_legacyzstd"])
def test_kernel_d_qt_matches_plain(dev, src):
    """D-QT against its plain version within 32 ulp of sf * max|coef| of the
    block, on a port container and on the committed JAX-package QT
    container of 7777 samples, whose partial last block runs D-QT's
    rem-point tail; that container decodes on the card through C and D-QT
    alone."""
    import pathlib

    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.ops import dpk_fuse as fk

    if isinstance(src, str):
        blob = (pathlib.Path(__file__).parent / "golden" / f"{src}.z").read_bytes()
    else:
        cfg = dz.CodecConfig(mode="qt", container="v2", ids_codec="device",
                             verify=True, segment_elems=0)
        blob = dz.compress(_qt_input(src, src), config=cfg, device="cpu")
    header, d_in, dc_d, ac_d, q, n_stream, cw, hcfg = _decode_inputs(dev, blob)
    nblk = -(-n_stream // 64)
    ik, ak = fk.dpk_unpack_expand(*d_in, ac_d, nblk, n_stream, cw)
    sf = torch.tensor(header.scaling_factor, dtype=torch.float32, device=dev)
    fk.reset_launches()
    xk = fk.dequant_idct(ik, ak, dc_d, sf, hcfg, n_stream, q)[:n_stream]
    assert fk.LAUNCHES["dequant_idct_qt"] == 1
    xp = fk._dequant_idct_plain(ik, ak, dc_d, sf, hcfg, n_stream, q)[:n_stream]
    co = qz.decode_dense(ik, dc_d, ak, nblk * 64, hcfg, q)
    lim = (32 * 2.0**-23 * header.scaling_factor * co.abs().amax(1)).repeat_interleave(64)
    assert torch.all((xk - xp).abs() <= lim[:n_stream])
    if isinstance(src, str):
        assert header.num_elements % 64
        fk.reset_launches()
        got = dz.decompress(blob, device="cuda")
        assert {k for k, v in fk.LAUNCHES.items() if v} == {
            "dpk_unpack_expand", "dequant_idct_qt"}
        ref = dz.decompress(blob, device="cpu")
        assert np.abs(got - ref).max() <= lim.max().item()


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_dtzs_round_trip_on_card(dev, mode):
    """A DTZS stream written on the card (three frames) launches the mode's
    kernels, holds the bound, decodes bit-equal to the monolithic container
    of the same data and equals the stream the plain path writes within
    the ratio tolerance."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.ops import dpk_fuse as fk

    n = 4 * TILE_N + 1025
    x = _qt_input(n, 5)
    cfg = dz.CodecConfig(mode=mode, container="v2", ids_codec="device",
                         verify=True, segment_elems=2 * TILE_N)
    fk.reset_launches()
    blob = dz.compress(x, config=cfg, device="cuda")
    y = dz.decompress(blob, device="cuda")
    assert blob[:4] == b"DTZS"
    assert {k for k, v in fk.LAUNCHES.items() if v} == (
        QT_KERNELS if mode == "qt" else EC_KERNELS)
    assert dz.evaluate(x, y, 1e-3)["bound_satisfied"]
    import dataclasses

    mono = dz.compress(x, config=dataclasses.replace(cfg, segment_elems=0),
                       device="cuda")
    assert dz.decompress(mono, device="cuda").tobytes() == y.tobytes()
    blob_cpu = dz.compress(x, config=cfg, device="cpu")
    assert abs(len(blob) / len(blob_cpu) - 1.0) <= 1e-3
    assert np.abs(dz.decompress(blob_cpu, device="cuda") - x).max() <= 1e-3 * float(x.max() - x.min())


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 4 * TILE_N + 17])
def test_f32_delta_dev_on_card(dev, n):
    """The device DC delta and its inverse on the card equal the host's
    entropy.f32_delta bit for bit (negatives, -0.0 and subnormals among
    the values)."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import entropy

    rng = np.random.default_rng(n)
    a = (rng.standard_normal(n) * 1e3).astype(np.float32)
    a[::7] = -0.0
    a[::11] = np.float32(1e-40)
    a[::13] = -np.float32(3e-42)
    d = api._f32_delta_dev(torch.from_numpy(a).to(dev))
    assert d.cpu().numpy().tobytes() == entropy.f32_delta(a).tobytes()
    assert api._f32_delta_inv_dev(d).cpu().numpy().tobytes() == a.tobytes()


#: host-coded DTZS configurations on the card: (config keywords, the
#: kernels a round trip launches: kernel H in each frame's compaction,
#: I and D or D-QT in each frame's decode; the generic chain's transform,
#: bins and repair are torch ops)
GENERIC_DTZS = {
    "ec_deflate": (dict(mode="ec", container="v2", ids_codec="deflate"),
                   {"chunk_compact", "chunk_expand", "dequant_idct"}),
    "qt_deflate": (dict(mode="qt", container="v2", ids_codec="deflate"),
                   {"chunk_compact", "chunk_expand", "dequant_idct_qt"}),
    "v1": (dict(mode="ec"), {"chunk_compact", "chunk_expand", "dequant_idct"}),
    "qt_v1_dcd": (dict(mode="qt", dc_delta=True),
                  {"chunk_compact", "chunk_expand", "dequant_idct_qt"}),
}


@pytest.mark.parametrize("case", list(GENERIC_DTZS))
def test_generic_dtzs_round_trip_on_card(dev, case):
    """A DTZS stream of host-coded frames written on the card (three frames,
    the last ending mid-block), verify on, launches H, I and D (D-QT) and no
    other kernel, holds the bound, and each path decodes the other's stream
    within the bound: on the x30 signal, where the stream's ratio is held
    to the plain path's, and on a narrow one, where the repair forces
    escapes in many blocks. There the two float32 matmul orders (cuBLAS,
    the CPU's) meet the tolerance in different blocks, so its ratio is not
    compared."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.ops import dpk_fuse as fk

    kw, want = GENERIC_DTZS[case]
    n = 4 * TILE_N + 1025
    cfg = dz.CodecConfig(verify=True, segment_elems=2 * TILE_N, **kw)
    for x, same_ratio in ((_qt_input(n, 11), True), (_signal(n, 11, narrow=True), False)):
        fk.reset_launches()
        blob = dz.compress(x, config=cfg, device="cuda")
        y = dz.decompress(blob, device="cuda")
        assert blob[:4] == b"DTZS"
        assert {k for k, v in fk.LAUNCHES.items() if v} == want
        assert dz.evaluate(x, y, 1e-3)["bound_satisfied"]
        blob_cpu = dz.compress(x, config=cfg, device="cpu")
        if same_ratio:
            assert abs(len(blob) / len(blob_cpu) - 1.0) <= 1e-3
        tol = 1e-3 * float(x.max() - x.min())
        assert np.abs(dz.decompress(blob_cpu, device="cuda") - x).max() <= tol
        assert np.abs(dz.decompress(blob, device="cpu") - x).max() <= tol


@pytest.mark.parametrize("segment_elems", [0, 2 * TILE_N])
def test_dc_delta_dpk_on_card(dev, segment_elems):
    """dc_delta on the DPK routes on the card: A, B, C and D launch, and the
    decode is bit-equal to that of the same configuration without the
    delta."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.ops import dpk_fuse as fk

    x = _signal(4 * TILE_N + 1025, 12)
    kw = dict(mode="ec", container="v2", ids_codec="device", verify=True,
              segment_elems=segment_elems)
    fk.reset_launches()
    y = dz.decompress(dz.compress(x, config=dz.CodecConfig(dc_delta=True, **kw),
                                  device="cuda"), device="cuda")
    assert {k for k, v in fk.LAUNCHES.items() if v} == EC_KERNELS
    plain = dz.decompress(dz.compress(x, config=dz.CodecConfig(**kw), device="cuda"),
                          device="cuda")
    assert y.tobytes() == plain.tobytes()


V1_KERNELS = {"dct_quant", "chunk_compact", "chunk_expand", "dequant_idct"}


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("n,kind", [(3 * TILE_N, "aligned"), (5 * TILE_N - 11, "aligned")]
                         + [(n, "aligned") for n in TILE_EDGES]
                         + [(5 * TILE_N - 11, "misaligned")])
def test_kernels_f_g_match_plain(dev, mode, n, kind):
    """F and G against their plain version (a torch matmul) on the same
    inputs: ids within 1e-4, DC and stored values within the coefficient
    budget (QT: times eb*qt_factor/q[k], plus 4 ulp); and F against A with
    verify off: the same ids at every AC position and the same values at
    the DC and the escapes (one forward-DCT function). Also on a
    misaligned view of the input."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode as fe

    x = _qt_input(n, n + 7) if mode == "qt" else _signal(n, n + 7)
    xp = _padded_on(dev, x)
    sf, _ = api._stats_device(xp, n, 1)
    q = _qtable(dev, xp, sf) if mode == "qt" else None
    fk.reset_launches()
    ik, dk = fe.dct_quant(_off16(xp) if kind == "misaligned" else xp, sf, 1e-3, q)
    assert fk.LAUNCHES["dct_quant_qt" if q is not None else "dct_quant"] == 1
    ip, dp = fe._dct_quant_plain(xp, sf, CodecConfig(mode=mode, error_bound=1e-3), q)
    assert (ik != ip).float().mean().item() <= 1e-4
    budget = 32 * 2.0**-23 * (xp / sf).reshape(-1, 64).abs().amax(1, keepdim=True)
    col = torch.arange(64, device=dev)
    esc = (ik == 255) & (col > 0)
    lim = budget.expand_as(dp)
    if q is not None:
        lim = torch.where(esc, budget * 1e-2 / q + 4 * 2.0**-23 * dp.abs(), lim)
    assert torch.all(((dk - dp).abs() <= lim)[ik == ip])
    if q is None:
        _ia, ca, _ok = fk.dct_quant_verify(xp, sf, torch.ones((), device=dev), n,
                                           1e-3, False)
        assert torch.equal(ik[:, 1:], _ia[:, 1:])
        assert torch.equal(dk[esc], ca[esc]) and torch.equal(dk[:, 0], ca[:, 0])


#: chunk widths of kernels H and J's card tests: every width the word walk
#: takes up to 2048 (rows across 2 and 4 warp steps from 1024), and 384,
#: which takes the lane walk
HJ_WIDTHS = [64, 128, 256, 512, 1024, 2048, 384]


def _walk_case(cw):
    return "lanes" if cw == 384 else "words"


@pytest.mark.parametrize("cw", HJ_WIDTHS)
@pytest.mark.parametrize("density", [0.0, 0.03, 0.25, 1.0])
def test_kernels_h_i_byte_equal(dev, cw, density):
    """H and I against compact_rows / expand_rows, byte for byte, at
    capacities that are not lane multiples and at cw (the overflow retry's);
    I on float32 and int32 rows. 77 rows leave the last group of rows of
    H's word walk partial; H takes the instantiation named."""
    from dctz_tpu_torch.ops import compaction as cp
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import shuffle

    rng = np.random.default_rng(cw + int(density * 100))
    nc = 77
    mask = torch.from_numpy(rng.random((nc, cw)) < density).to(dev)
    vals = torch.from_numpy(rng.standard_normal((nc, cw)).astype(np.float32)).to(dev)
    for capc in sorted({min(96, cw), min(130, cw), cw}):
        walk = _walk_case(cw)
        assert shuffle.walk_of(cw, 4 * capc, mask.data_ptr()) == walk
        fk.reset_launches()
        rows, counts = shuffle.compact_f32(mask, vals, capc)
        assert fk.LAUNCHES["chunk_compact"] == 1
        assert fk.INSTANTIATIONS[shuffle._instantiation("chunk_compact", walk)] == 1
        rows_p, counts_p = cp.compact_rows(mask, vals, capc)
        assert torch.equal(rows.view(torch.int32), rows_p.view(torch.int32))
        assert torch.equal(counts, counts_p)
        back = shuffle.expand(mask, rows)
        assert fk.LAUNCHES["chunk_expand"] == 1
        assert torch.equal(back.view(torch.int32),
                           cp.expand_rows(mask, rows).view(torch.int32))
        ints = rows.view(torch.int32)
        assert torch.equal(shuffle.expand(mask, ints), cp.expand_rows(mask, ints))


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("n", [3 * TILE_N, 7777, 3 * TILE_N + 128])
def test_v1_round_trip_on_card(dev, mode, n):
    """v1 containers on the card: the fused branch (n % 1024 == 0) and the
    generic chain (a rem-point tail; chunk width 128) hold the bound with
    verify on, launch the path's kernels, match the plain path's ratio and
    decode each other's containers within the bound."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.ops import dpk_fuse as fk

    x = _qt_input(n, n + 2)
    cfg = dz.CodecConfig(mode=mode, verify=True)
    fk.reset_launches()
    blob = dz.compress(x, config=cfg, device="cuda")
    y = dz.decompress(blob, device="cuda")
    launched = {k for k, v in fk.LAUNCHES.items() if v}
    if n % 1024 == 0:
        want = {"dct_quant_qt", "qtable_qmax"} if mode == "qt" else {"dct_quant"}
    else:
        want = set()
    want |= {"chunk_compact", "chunk_expand",
             "dequant_idct_qt" if mode == "qt" else "dequant_idct"}
    assert launched == want
    assert blob[:4] != b"DTZS" and dz.evaluate(x, y, 1e-3)["bound_satisfied"]
    blob_cpu = dz.compress(x, config=cfg, device="cpu")
    assert abs(len(blob) / len(blob_cpu) - 1.0) <= 1e-3
    tol = 1e-3 * float(x.max() - x.min())
    assert np.abs(dz.decompress(blob_cpu, device="cuda") - x).max() <= tol
    assert np.abs(dz.decompress(blob, device="cpu") - x).max() <= tol


def test_tf32_is_refused(dev):
    import dctz_tpu_torch as dz

    x = _signal(7777, 1)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            dz.compress(x, device="cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("cw", [128, 512] + [w for w in HJ_WIDTHS if w not in (128, 512)])
@pytest.mark.parametrize("density", [0.0, 0.03, 0.25, 1.0])
def test_kernels_j_k_byte_equal(dev, cw, density):
    """J and K against their plain versions, byte for byte, at capacities
    that are not lane multiples, at J's cut above cape (96 -> 128) and at
    cw; J and K take the instantiation named."""
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import shuffle

    rng = np.random.default_rng(3 * cw + int(density * 100))
    nc = 77
    mask = torch.from_numpy(rng.random((nc, cw)) < density).to(dev)
    idb = rng.integers(0, 255, (nc, cw)).astype(np.uint8)
    idb = torch.from_numpy(np.where(rng.random((nc, cw)) < 0.3, np.uint8(255), idb)).to(dev)
    vals = torch.from_numpy(rng.standard_normal((nc, cw)).astype(np.float32)).to(dev)
    for capc in (96, 130):
        walk = _walk_case(cw)
        assert shuffle.walk_of(cw, min(capc, cw), mask.data_ptr(), idb.data_ptr()) == walk
        fk.reset_launches()
        got = shuffle.compact_bytes(mask, idb, capc)
        assert fk.LAUNCHES["chunk_compact_bytes"] == 1
        assert fk.INSTANTIATIONS[shuffle._instantiation("chunk_compact_bytes", walk)] == 1
        assert torch.equal(got, shuffle.compact_bytes(mask.cpu(), idb.cpu(), capc).to(dev))
    for cape, capc in ((96, 96), (130, 130), (96, 130), (cw, cw)):
        walk = _walk_case(cw)
        assert shuffle.walk_of(cw, min(cape, cw) + 4 * min(capc, cw), mask.data_ptr(),
                               idb.data_ptr()) == walk
        fk.reset_launches()
        got = shuffle.compact_unified(mask, idb, vals, cape, capc)
        assert fk.LAUNCHES["chunk_compact_unified"] == 1
        assert fk.INSTANTIATIONS[shuffle._instantiation("chunk_compact_unified", walk)] == 1
        ref = shuffle.compact_unified(mask.cpu(), idb.cpu(), vals.cpu(), cape, capc)
        assert torch.equal(got[0].cpu(), ref[0])
        assert torch.equal(got[1].cpu().view(torch.int32), ref[1].view(torch.int32))


@pytest.mark.parametrize("cw,offset", [(cw, off) for cw in (128, 512) for off in (1, 4, 16)]
                         + [(1024, 16)])
def test_kernels_h_j_on_mask_views(dev, cw, offset):
    """H, J and K on mask and id-byte views that start `offset` bytes into
    their buffers: off 16 bytes they take the lane walk, on 16 the word
    walk; all give their plain versions' bytes, at a density where rows
    overflow 96 slots (0.9)."""
    from dctz_tpu_torch.ops import compaction as cp
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import shuffle

    rng = np.random.default_rng(cw + offset)
    nc = 77
    walk = "words" if offset % 16 == 0 else "lanes"
    buf = torch.from_numpy(rng.random(nc * cw + offset) < 0.9).to(dev)
    mask = buf[offset:].view(nc, cw)
    ids = rng.integers(0, 255, nc * cw + offset).astype(np.uint8)
    ids = torch.from_numpy(np.where(rng.random(ids.size) < 0.3, np.uint8(255), ids)).to(dev)
    idb = ids[offset:].view(nc, cw)
    vals = torch.from_numpy(rng.standard_normal((nc, cw)).astype(np.float32)).to(dev)
    assert mask.data_ptr() % 16 == offset % 16 and idb.data_ptr() % 16 == offset % 16
    fk.reset_launches()
    rows, counts = shuffle.compact_f32(mask, vals, 96)
    got = shuffle.compact_unified(mask, idb, vals, 96, 96)
    got_k = shuffle.compact_bytes(mask, idb, 96)
    took = {shuffle._instantiation(k, walk)
            for k in ("chunk_compact", "chunk_compact_unified", "chunk_compact_bytes")}
    assert fk.INSTANTIATIONS == {k: int(k in took) for k in fk.INSTANTIATIONS}
    rows_p, counts_p = cp.compact_rows(mask, vals, 96)
    assert bool((counts_p > 96).any())
    assert torch.equal(rows.view(torch.int32), rows_p.view(torch.int32))
    assert torch.equal(counts, counts_p)
    ref = shuffle.compact_unified(mask.cpu(), idb.cpu(), vals.cpu(), 96, 96)
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu().view(torch.int32), ref[1].view(torch.int32))
    assert torch.equal(got_k.cpu(), shuffle.compact_bytes(mask.cpu(), idb.cpu(), 96))
    assert torch.equal(got_k, got[0])


@pytest.mark.parametrize("nblk,b,cape", [(512, 64, 128), (700, 64, 128), (700, 32, 256),
                                         (512, 128, 512)])
def test_pack_ids_with_ac_launches_j(dev, nblk, b, cape):
    """At a tile other than 256, pack_ids_with_ac on the card runs kernel J
    alone and gives its plain version's bytes."""
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import idpack

    ids, vals = _ids(np.random.default_rng(nblk + b), nblk, 0.02)
    it, vt = torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev)
    fk.reset_launches()
    got = idpack.pack_ids_with_ac(it, vt, nblk * 64 - 7, b, cape)
    assert {k for k, v in fk.LAUNCHES.items() if v} == {"chunk_compact_unified"}
    ref = idpack.pack_ids_with_ac(it.cpu(), vt.cpu(), nblk * 64 - 7, b, cape)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g.cpu(), r)


def _bench(n):
    from dctz_tpu_torch.utils.bench_data import climate_formula_np

    return climate_formula_np(n)


@pytest.mark.parametrize("n", [TILE_N, 5 * TILE_N - 1024, 16 * TILE_N])
def test_kernel_l_byte_equal(dev, n):
    """L against its plain version, and against F, then pack_ids (kernel H)
    at cape 128, then H of F's escapes, on the card: the same bytes, DC by
    value (one forward-DCT function, kernel F's)."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode as fe
    from dctz_tpu_torch.ops import idpack, shuffle
    from dctz_tpu_torch.ops.research import fused_encode_dpk as fed

    x = torch.from_numpy(_bench(n)).to(dev)
    sf, _ = api._stats_device(x, n, 1)
    fk.reset_launches()
    got = fed.fused_encode_dpk(x, sf, 1e-3)
    assert {k for k, v in fk.LAUNCHES.items() if v} == {"fused_encode_dpk"}
    plain = fed._fused_encode_dpk_plain(x, sf, 1e-3)
    ids, dcac = fe.dct_quant(x, sf, 1e-3)
    chain = idpack.pack_ids(ids, n, 256, 128)[:4]
    esc = (ids == 255) & (torch.arange(64, device=dev) > 0)
    chain += shuffle.compact_f32(esc.reshape(-1, 512), dcac.reshape(-1, 512), 128)
    chain += (dcac[:, 0],)
    ids_g = idpack.unpack_ids(*got[:3], n // 64, 64, 256, 512)
    ids_p = idpack.unpack_ids(*plain[:3], n // 64, 64, 256, 512)
    assert (ids_g != ids_p).float().mean().item() <= 1e-4
    for i, (g, c) in enumerate(zip(got, chain)):
        assert g.dtype == c.dtype and g.shape == c.shape, i
        assert torch.equal(g, c) if i != 6 else bool((g == c).all()), i
    if torch.equal(ids_g, ids_p):
        for i in (0, 1, 2, 3, 5):
            assert torch.equal(got[i], plain[i]), i


def _decode_case(dev, b, mode, esc_p, seed):
    """Decode inputs at tile b (four tiles and three quarters of a fifth)
    built with the port's own coder: pack_ids at full capacity, exception
    rows cut to the smallest tier that holds the peak, AC rows of
    out-of-range values at the escapes."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.ops import compaction as cp
    from dctz_tpu_torch.ops import idpack

    rng = np.random.default_rng(seed)
    nblk = 4 * b + 3 * b // 4
    n = nblk * 64
    ids, _ = _ids(rng, nblk, esc_p)
    cw = qz.chunk_width(n, 64)
    w, pk, exc, cnt, _ = idpack.pack_ids(torch.from_numpy(ids), n, b, cw)
    cape = next(c for c in (32, 64, 128) if c >= int(cnt.max()))
    esc = torch.from_numpy((ids == 255) & (np.arange(64) >= 1))
    dense = torch.from_numpy((rng.standard_normal((nblk, 64)) * 3 + 1.0).astype(np.float32))
    ac, acn = cp.compact_rows(esc.reshape(-1, cw), dense.reshape(-1, cw), 128)
    assert int(acn.max()) <= 128
    dc = torch.from_numpy((rng.standard_normal(nblk) * 10).astype(np.float32))
    q = (torch.from_numpy(np.abs(rng.standard_normal(64)).astype(np.float32) + 1.0)
         if mode == "qt" else None)
    arrays = [a.contiguous().to(dev) for a in (w, pk, exc[:, :cape], dc, ac)]
    cfg = dz.CodecConfig(mode=mode, error_bound=1e-3)
    return arrays, n, cw, cfg, None if q is None else q.to(dev)


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("b", [32, 64, 256])
def test_kernel_m_matches_plain(dev, mode, b):
    """M against its plain version within 32 ulp of sf * max|coef| of the
    block (kernel D's budget), at tiles 32, 64 and 256 with a partial tail."""
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops.research import fused_decode as fd

    arrays, n, cw, cfg, q = _decode_case(dev, b, mode, 0.02, b)
    sf = torch.tensor(37.5, device=dev)
    fk.reset_launches()
    got = fd.fused_decode_dpk(*arrays, sf, n, b, cw, cfg, q)
    assert fk.LAUNCHES["fused_decode_dpk"] == 1
    ref = fd._fused_decode_dpk_plain(*arrays, sf, n, b, cw, cfg, q)
    co = fd._coefficients_plain(*arrays, b, cw, cfg, q)
    lim = (32 * 2.0**-23 * 37.5 * co.abs().amax(1)).repeat_interleave(64)[:n]
    assert got.shape == ref.shape == (n,)
    assert torch.all((got - ref).abs() <= lim)


def test_kernel_m_equals_c_d_at_tile_256(dev):
    """On L's streams of the benchmark array, M decodes C + D's bits."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import api
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops.research import fused_decode as fd
    from dctz_tpu_torch.ops.research import fused_encode_dpk as fed

    n = 5 * TILE_N - 1024
    x = torch.from_numpy(_bench(n)).to(dev)
    sf, _ = api._stats_device(x, n, 1)
    w, pk, exc, _ec, ac, _acn, dc = fed.fused_encode_dpk(x, sf, 1e-3)
    cfg = dz.CodecConfig(error_bound=1e-3)
    fk.reset_launches()
    got = fd.fused_decode_dpk(w, pk, exc, dc, ac, sf, n, 256, 512, cfg)
    assert {k for k, v in fk.LAUNCHES.items() if v} == {"fused_decode_dpk"}
    ref = fk.decode_fused(w, pk, exc, ac, dc, sf, cfg, 512, n)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert (got - x).abs().max().item() <= 1e-3 * float(x.max() - x.min())


def test_kernel_m_refuses_a_tile_beyond_one_block(dev):
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.ops.research import fused_decode as fd

    b = 512
    z = lambda *s, **k: torch.zeros(s, device=dev, **k)  # noqa: E731
    args = (z(1, 64, dtype=torch.uint8), z(64, b // 2, dtype=torch.uint8),
            z(64, 128, dtype=torch.uint8), z(b), z(64, 128), torch.tensor(1.0, device=dev))
    with pytest.raises(ValueError, match="at most 256"):
        fd.fused_decode_dpk(*args, b * 64, b, 512, dz.CodecConfig())


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("n_valid", [5 * 1024, 3 * CTA_N + 2048 - 11, 5 * TILE_N - 11])
def test_kernel_a_at_tile_edges(dev, mode, n_valid):
    """A and A-QT with verify on where the padded length is not a multiple of
    A's 64-block tile (and, for comparison, where it is), on a narrow signal
    that gives the repair work: the ids of at most 2 + nblk/100 blocks
    differ from the plain version's (a block near the bound can be repaired
    by one and not the other: their reconstructions differ in the last
    ulps), the same verified flag, the decode of A's output (kernel D)
    within the tolerance wherever A says so, coefficients (EC) within 32
    ulp of max|x/sf| of the block; the screen counters flag at least the
    blocks they repair, and about as many as the plain version's."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode as fe

    xp = _padded_on(dev, _signal(n_valid, n_valid, narrow=True))
    sf, _ = api._stats_device(xp, n_valid, 1)
    q = fe.qtable_qmax(xp, sf, 1e-3) if mode == "qt" else None
    tol = fe.tolerance(xp, n_valid, 1e-3)
    ck = torch.zeros(2, dtype=torch.int64, device=dev)
    cp_ = torch.zeros(2, dtype=torch.int64, device=dev)
    fk.reset_launches()
    ik, vk, okk = fk.dct_quant_verify(xp, sf, tol, n_valid, 1e-3, True, q, ck)
    assert fk.LAUNCHES["dct_quant_verify_qt" if q is not None else "dct_quant_verify"] == 1
    ip, vp, okp = fk._dct_quant_verify_plain(
        xp, sf, tol, n_valid, CodecConfig(mode=mode, error_bound=1e-3), True, q, cp_)
    assert int((ik != ip).any(1).sum()) <= 2 + ik.shape[0] // 100
    assert bool(okk) == bool(okp)
    ids_d = ik.clone()
    ids_d[:, 0] = 255
    esc = (ids_d == 255) & (torch.arange(64, device=dev) > 0)
    cfg = CodecConfig(mode=mode, error_bound=1e-3)
    rec = fk.dequant_idct(ids_d, torch.where(esc, vk, torch.zeros_like(vk)),
                          vk[:, 0].contiguous(), sf, cfg, xp.numel(), q)
    if bool(okk):
        assert (rec - xp)[:n_valid].abs().max().item() <= tol.item()
    if q is None:
        budget = 32 * 2.0**-23 * (xp / sf).reshape(-1, 64).abs().amax(1, keepdim=True)
        assert torch.all((vk - vp).abs() <= budget)
    flagged, repaired = ck.tolist()
    flagged_p, missed_p = cp_.tolist()
    assert 0 < repaired <= flagged <= xp.numel() // 64
    assert abs(flagged - flagged_p) <= 1 + 0.02 * flagged_p
    assert abs(repaired - missed_p) <= 1 + 0.02 * missed_p


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("n,kind", [(n, "aligned") for n in TILE_EDGES]
                         + [(5 * TILE_N - 11, "misaligned")])
def test_kernel_a_equals_f_g(dev, mode, n, kind):
    """A (verify off) against F, and A-QT against G: the same staging and
    register-tiled transform (csrc/dct_tile.cuh) behind different
    epilogues, so the same ids at every AC position and the same values at
    DC and at the AC escapes, bit for bit (kernel L's per-thread transform,
    test_kernel_l_byte_equal, is the independent check of the header). Also
    with F/G given a misaligned view of the input."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode as fe

    xp = _padded_on(dev, _qt_input(n, n + 5) if mode == "qt" else _signal(n, n + 5))
    sf, _ = api._stats_device(xp, n, 1)
    q = _qtable(dev, xp, sf) if mode == "qt" else None
    ia, va, _ok = fk.dct_quant_verify(xp, sf, torch.ones((), device=dev), n, 1e-3, False, q)
    ifg, dfg = fe.dct_quant(_off16(xp) if kind == "misaligned" else xp, sf, 1e-3, q)
    esc = (ifg == 255) & (torch.arange(64, device=dev) > 0)
    assert esc.any()
    assert torch.equal(ia[:, 1:], ifg[:, 1:])
    assert torch.equal(va[esc].view(torch.int32), dfg[esc].view(torch.int32))
    assert torch.equal(va[:, 0].view(torch.int32), dfg[:, 0].view(torch.int32))


@pytest.mark.parametrize("n", TILE_EDGES)
def test_kernel_e_equals_a_at_tile_edges(dev, n):
    """E's qtable is the clamped maximum over the escaping coefficients of
    A-EC, bit for bit, where A's last tile is partial."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.ops import dpk_fuse as fk

    xp = _padded_on(dev, _qt_input(n, n + 9))
    sf, _ = api._stats_device(xp, n, 1)
    got = _qtable(dev, xp, sf)
    _ids, coef, _ok = fk.dct_quant_verify(xp, sf, sf, n, 1e-3, False)
    _w, rmin, rmax = qz._geometry(CodecConfig(error_bound=1e-3))
    esc = ~((coef >= rmin) & (coef <= rmax)) & (torch.arange(64, device=dev) > 0)
    from_a = torch.where(esc, coef.abs(), torch.zeros_like(coef)).amax(0)
    assert torch.equal(got, torch.clamp_min(from_a, 1.0))


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("nblk,rem", [(1, 0), (1, 5), (63, 0), (65, 33), (130, 1), (191, 63)])
def test_kernel_d_at_tile_edges(dev, mode, nblk, rem):
    """D and D-QT where the block count is not a multiple of D's 64-block
    tile, with and without a partial last block of rem samples (its
    rem-point tail): within 32 ulp of sf * max|coef| of the block of the
    plain version, on the n_stream samples."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.ops import dpk_fuse as fk

    rng = np.random.default_rng(nblk * 64 + rem)
    ids, acv = _ids(rng, nblk, 0.05)
    it, at = torch.from_numpy(ids).to(dev), torch.from_numpy(acv * 3).to(dev)
    dc = torch.from_numpy((rng.standard_normal(nblk) * 10).astype(np.float32)).to(dev)
    q = (torch.from_numpy(np.abs(rng.standard_normal(64)).astype(np.float32) + 1.0).to(dev)
         if mode == "qt" else None)
    cfg = dz.CodecConfig(mode=mode, error_bound=1e-3)
    n_stream = nblk * 64 - (64 - rem if rem else 0)
    sf = torch.tensor(37.5, device=dev)
    fk.reset_launches()
    got = fk.dequant_idct(it, at, dc, sf, cfg, n_stream, q)[:n_stream]
    assert fk.LAUNCHES["dequant_idct_qt" if q is not None else "dequant_idct"] == 1
    ref = fk._dequant_idct_plain(it, at, dc, sf, cfg, n_stream, q)[:n_stream]
    co = qz.decode_dense(it, dc, at, nblk * 64, cfg, q)
    lim = (32 * 2.0**-23 * 37.5 * co.abs().amax(1)).repeat_interleave(64)[:n_stream]
    assert torch.all((got - ref).abs() <= lim)


def test_kernel_m_qt_equals_c_d_qt_at_tile_256(dev):
    """M-QT decodes C + D-QT's bits at tile 256, on G's streams coded by B
    at a block count that is not a multiple of 64 (nor of 256)."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import api
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode as fe
    from dctz_tpu_torch.ops.research import fused_decode as fd

    n = 5 * TILE_N - 1024
    xp = _padded_on(dev, _qt_input(n, 11))
    sf, _ = api._stats_device(xp, n, 1)
    q = _qtable(dev, xp, sf)
    ids, dcac = fe.dct_quant(xp, sf, 1e-3, q)
    cfg = dz.CodecConfig(mode="qt", error_bound=1e-3)
    for cw in (512, 256, 128):
        st = fk.encode_fused(ids, dcac, n, 256, cw, cw)
        if int(st[3].max()) <= 128 and int(st[5].max()) <= 128:
            break
    else:
        pytest.fail("every chunk width overflows 128")
    w, pk, exc, ac, dc = (st[0], st[1], st[2][:, :128].contiguous(), st[4][:, :128].contiguous(),
                          st[6])
    fk.reset_launches()
    got = fd.fused_decode_dpk(w, pk, exc, dc, ac, sf, n, 256, cw, cfg, q)
    assert fk.LAUNCHES["fused_decode_dpk"] == 1
    ref = fk.decode_fused(st[0], st[1], st[2], st[4], st[6], sf, cfg, cw, n, q)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


# Kernels L and M against their card-only references L_ref and M_ref
# (csrc/*_ref.cu, ops/research/_ref.py), which keep the per-thread
# transforms of common.cuh and the per-byte DPK stages.

#: lengths for L: one tile, a ragged last tile whose last 64-block sub-tile
#: is partial (3 of its 4 KB), sixteen tiles, and a last sub-tile of 1 KB
L_LENGTHS = [TILE_N, 5 * TILE_N - 1024, 16 * TILE_N, 2 * TILE_N + 1024]


@pytest.mark.parametrize("n", L_LENGTHS)
def test_kernel_l_equals_ref(dev, n):
    """L equals L_ref bit for bit on all seven streams, and L_ref equals F,
    then pack_ids (kernel H) at cape 128, then H of F's escapes (the check of
    the tiled forward transform against the per-thread one). Only L's launch
    counts."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode as fe
    from dctz_tpu_torch.ops import idpack, shuffle
    from dctz_tpu_torch.ops.research import _ref
    from dctz_tpu_torch.ops.research import fused_encode_dpk as fed

    x = torch.from_numpy(_bench(n)).to(dev)
    sf, _ = api._stats_device(x, n, 1)
    fk.reset_launches()
    got = fed.fused_encode_dpk(x, sf, 1e-3)
    ref = _ref.fused_encode_dpk_ref(x, sf, 1e-3)
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {"fused_encode_dpk": 1}
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and g.shape == r.shape, i
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                           r.view(torch.int32) if r.dtype == torch.float32 else r), i
    ids, dcac = fe.dct_quant(x, sf, 1e-3)
    chain = idpack.pack_ids(ids, n, 256, 128)[:4]
    esc = (ids == 255) & (torch.arange(64, device=dev) > 0)
    chain += shuffle.compact_f32(esc.reshape(-1, 512), dcac.reshape(-1, 512), 128)
    chain += (dcac[:, 0],)
    for i, (r, c) in enumerate(zip(ref, chain)):
        assert torch.equal(r, c) if i != 6 else bool((r == c).all()), i


def _decode_case_at(dev, b, cw, nblk, mode, seed):
    """Decode inputs at tile b and chunk width cw over nblk blocks (nblk * 64
    a multiple of cw): widths and packing of idpack._code_tiles, the
    exception bytes and the AC values of out-of-range samples compacted per
    chunk row at capacity 128 (rows past it keep their first 128), the
    exception rows cut to the smallest tier that holds the peak."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.ops import compaction as cp
    from dctz_tpu_torch.ops import idpack

    rng = np.random.default_rng(seed)
    ids, _ = _ids(rng, nblk, 0.02)
    n = nblk * 64
    w, pk, ids_i, mask = idpack._code_tiles(torch.from_numpy(ids), n, b)
    exc, cnt = cp.compact_rows(mask.reshape(-1, cw), ids_i.to(torch.uint8).reshape(-1, cw), 128)
    cape = next(c for c in (32, 64, 128) if c >= min(int(cnt.max()), 128))
    esc = torch.from_numpy((ids == 255) & (np.arange(64) >= 1))
    dense = torch.from_numpy((rng.standard_normal((nblk, 64)) * 3 + 1.0).astype(np.float32))
    ac, _acn = cp.compact_rows(esc.reshape(-1, cw), dense.reshape(-1, cw), 128)
    dc = torch.from_numpy((rng.standard_normal(nblk) * 10).astype(np.float32))
    q = (torch.from_numpy(np.abs(rng.standard_normal(64)).astype(np.float32) + 1.0)
         if mode == "qt" else None)
    arrays = [a.contiguous().to(dev) for a in (w.to(torch.uint8), pk, exc[:, :cape], dc, ac)]
    cfg = dz.CodecConfig(mode=mode, error_bound=1e-3)
    return arrays, n, cfg, None if q is None else q.to(dev)


#: (b, cw, blocks, instantiation): tiles 32-256 with a partial tail tile at
#: cw 512, cw 64-256 and 8192 (rows across the 64-block units), a tile of
#: 96 (a guarded last unit), and chunk widths that are not powers of two,
#: which take the lane walk (rows across the units at 384)
M_GEOMS = [(32, 512, 152, "words"), (64, 512, 304, "words"), (128, 512, 608, "words"),
           (256, 512, 1216, "words"), (256, 128, 1216, "words"), (256, 256, 1216, "words"),
           (64, 64, 304, "words"), (256, 8192, 1152, "words"), (128, 8192, 640, "words"),
           (96, 1024, 432, "words"), (24, 192, 114, "lanes"), (96, 384, 432, "lanes"),
           (40, 2560, 200, "lanes")]


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("b,cw,nblk,walk", M_GEOMS)
def test_kernel_m_equals_ref(dev, mode, b, cw, nblk, walk):
    """M equals M_ref bit for bit, at tiles 24-256, chunk widths 64-8192, EC
    and QT, with a partial tail tile; the geometry takes the instantiation
    named (the library agrees with fused_decode.walk_of). Only M's launch
    counts."""
    from dctz_tpu_torch.kernels import build
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops.research import _ref
    from dctz_tpu_torch.ops.research import fused_decode as fd

    assert fd.walk_of(b, cw) == walk
    assert build.lib().dctz_fused_decode_dpk_word_walk(b, cw) == (walk == "words")
    arrays, n, cfg, q = _decode_case_at(dev, b, cw, nblk, mode, b * 7 + cw)
    sf = torch.tensor(37.5, device=dev)
    fk.reset_launches()
    got = fd.fused_decode_dpk(*arrays, sf, n, b, cw, cfg, q)
    ref = _ref.fused_decode_dpk_ref(*arrays, sf, n, b, cw, cfg, q)
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {"fused_decode_dpk": 1}
    assert got.shape == ref.shape == (n,)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_kernel_m_qt_equals_ref_on_x30(dev):
    """M-QT equals M_ref and C + D-QT bit for bit on G's streams of the x30
    input (qtable entries above 1) coded by B at tile 256, and M_ref equals
    C + D-QT (the check of the tiled inverse transform in QT)."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import api
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode as fe
    from dctz_tpu_torch.ops.research import _ref
    from dctz_tpu_torch.ops.research import fused_decode as fd

    n = 5 * TILE_N - 1024
    xp = _padded_on(dev, _qt_input(n, 13))
    sf, _ = api._stats_device(xp, n, 1)
    q = _qtable(dev, xp, sf)
    ids, dcac = fe.dct_quant(xp, sf, 1e-3, q)
    cfg = dz.CodecConfig(mode="qt", error_bound=1e-3)
    for cw in (512, 256, 128):
        st = fk.encode_fused(ids, dcac, n, 256, cw, cw)
        if int(st[3].max()) <= 128 and int(st[5].max()) <= 128:
            break
    else:
        pytest.fail("every chunk width overflows 128")
    w, pk, exc, ac, dc = (st[0], st[1], st[2][:, :128].contiguous(), st[4][:, :128].contiguous(),
                          st[6])
    got = fd.fused_decode_dpk(w, pk, exc, dc, ac, sf, n, 256, cw, cfg, q)
    ref = _ref.fused_decode_dpk_ref(w, pk, exc, dc, ac, sf, n, 256, cw, cfg, q)
    chain = fk.decode_fused(st[0], st[1], st[2], st[4], st[6], sf, cfg, cw, n, q)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(ref.view(torch.int32), chain.view(torch.int32))


def test_kernel_m_ref_equals_c_d_at_tile_256(dev):
    """On L's streams of the benchmark array, M_ref decodes C + D's bits
    (the check of the tiled inverse transform against the per-thread one)."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import api
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops.research import _ref
    from dctz_tpu_torch.ops.research import fused_encode_dpk as fed

    n = 5 * TILE_N - 1024
    x = torch.from_numpy(_bench(n)).to(dev)
    sf, _ = api._stats_device(x, n, 1)
    w, pk, exc, _ec, ac, _acn, dc = fed.fused_encode_dpk(x, sf, 1e-3)
    cfg = dz.CodecConfig(error_bound=1e-3)
    ref = _ref.fused_decode_dpk_ref(w, pk, exc, dc, ac, sf, n, 256, 512, cfg)
    chain = fk.decode_fused(w, pk, exc, ac, dc, sf, cfg, 512, n)
    assert torch.equal(ref.view(torch.int32), chain.view(torch.int32))


def _ptxas_spills(log: str) -> dict:
    """Spill bytes (stores + loads) per kernel name in nvcc's -Xptxas -v
    output."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '.*?\d+([a-z_]+)_kernel", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name is not None:
            out[name] = out.get(name, 0) + int(m.group(1)) + int(m.group(2))
    return out


def test_kernels_h_j_occupancy(dev):
    """H, J and K's word walks fit at least 2 resident CTAs per SM at their
    largest buffers on the API's paths; neither walk of any spills."""
    from dctz_tpu_torch.kernels import build

    build.lib()
    for k in ("chunk_compact", "chunk_compact_unified", "chunk_compact_bytes"):
        assert build.ctas_per_sm(k) >= 2, k
    spills = _ptxas_spills(build.PTXAS_LOG.read_text())
    for k in ("chunk_compact", "chunk_compact_lanes", "chunk_compact_unified",
              "chunk_compact_unified_lanes", "chunk_compact_bytes",
              "chunk_compact_bytes_lanes"):
        assert spills.get(k) == 0, (k, spills.get(k))


def test_kernels_l_m_occupancy(dev):
    """L and M (both instantiations) fit at least 2 resident CTAs per SM
    and do not spill."""
    from dctz_tpu_torch.kernels import build

    build.lib()
    for k in ("fused_encode_dpk", "fused_decode_dpk"):
        assert build.ctas_per_sm(k) >= 2, k
    spills = _ptxas_spills(build.PTXAS_LOG.read_text())
    for k in ("fused_encode_dpk", "fused_decode_dpk", "fused_decode_dpk_lanes"):
        assert spills.get(k) == 0, (k, spills.get(k))


# ---------------------------------------------------------------------------
# The relaxed analysis (CodecConfig.dct_precision="high"): the RELAXED
# instantiations of A, A-QT, E, F and G, three bfloat16 products on the
# tensor cores (csrc/dct_tile.cuh:tile_product_bf16x3)
# ---------------------------------------------------------------------------

#: a RELAXED kernel's coefficients against its plain version
#: (transform.dot_bf16x3), in eps32 * max|x/sf| of the block. Both take the
#: same bfloat16 parts, whose products are exact in float32, so they differ
#: only by the order of the float32 accumulation inside each of the three
#: products (the tensor cores' against cuBLAS'), as the HIGHEST kernels
#: differ from theirs; the bfloat16 representation error is the same on
#: both sides and is not in the budget.
RELAXED_BUDGET = 32
RELAXED = {"dct_quant_verify_relaxed", "dct_quant_verify_qt_relaxed",
           "qtable_qmax_relaxed", "dct_quant_relaxed", "dct_quant_qt_relaxed"}
#: the HIGHEST forward kernels, which a relaxed configuration never launches
HIGHEST_FORWARD = {k.removesuffix("_relaxed") for k in RELAXED}


def _budget(xp, sf, blocks=64):
    return RELAXED_BUDGET * 2.0**-23 * (xp / sf).reshape(-1, blocks).abs().amax(
        1, keepdim=True)


def near_edge(coef, budget, cfg, qtable=None):
    """Where a coefficient within `budget` of coef can take another bin id:
    coef within the budget (plus 4 ulp of the division by w) of a bin edge
    rmin + j*w or of the range's ends, or, QT, an out-of-range coef whose
    renormalized value lies within budget * eb * qt_factor / q[k] of one."""
    from dctz_tpu_torch.core import quantize as qz

    w, rmin, rmax = qz._geometry(cfg)
    eps = 2.0**-23

    def edge(v):
        u = (v - rmin) / w
        return torch.minimum((u - torch.round(u)).abs() * w,
                             torch.minimum((v - rmin).abs(), (v - rmax).abs()))

    near = edge(coef) <= budget + 4 * eps * (coef.abs() + abs(rmin))
    if qtable is not None:
        norm = qz.qt_renorm(coef, qtable, cfg)
        scale = cfg.error_bound * cfg.qt_factor / qtable.abs()[None, :]
        near |= (edge(norm) <= budget * scale + 4 * eps * (norm.abs() + abs(rmin))) & (
            (coef < rmin) | (coef > rmax))
    return near


def _ids_differ_only_near_edges(ik, ip, coef_p, budget, cfg, q=None):
    """The ids differ only where the plain coefficient is near an edge
    (near_edge), at DC never, and at most at 1e-4 of the positions."""
    near = near_edge(coef_p, budget, cfg, q)
    near[:, 0] = False
    differ = ik != ip
    assert not bool((differ & ~near).any())
    assert differ.float().mean().item() <= 1e-4
    return int(differ.sum()), int(near.sum())


def _one_sample_blocks(n, seed):
    """One nonzero sample per block, at a random position and amplitude."""
    rng = np.random.default_rng(seed)
    nb = -(-n // 64)
    x = np.zeros(nb * 64, np.float32)
    pos = rng.integers(0, 64, nb)
    x[np.arange(nb) * 64 + pos] = (rng.standard_normal(nb) * 30.0).astype(np.float32)
    return x[:n]


@pytest.mark.parametrize("n", [5 * TILE_N - 11] + TILE_EDGES)
def test_relaxed_split_is_bit_exact(dev, n):
    """With one nonzero sample per block each of the three bf16 products has
    one nonzero term, so no accumulation order rounds it: the RELAXED
    coefficients of A and F (and E's maxima over them) then depend on the
    bfloat16 split of xs and of the basis alone, and equal the plain
    version's (torch's round-to-nearest-even conversions, which
    tests/test_torch_precision.py holds bit-equal to JAX's astype), on the
    card and on the CPU."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode as fe

    xp = _padded_on(dev, _one_sample_blocks(n, n))
    sf, _ = api._stats_device(xp, n, 1)
    cfg = CodecConfig(error_bound=1e-3)
    _ia, ca, _ok = fk.dct_quant_verify(xp, sf, sf, n, 1e-3, False, relaxed=True)
    _if, df = fe.dct_quant(xp, sf, 1e-3, relaxed=True)
    _ip, cp_dev, _okp = fk._dct_quant_verify_plain(xp, sf, sf, n, cfg, False, relaxed=True)
    _ip, cp_cpu, _okp = fk._dct_quant_verify_plain(xp.cpu(), sf.cpu(), sf.cpu(), n, cfg,
                                                   False, relaxed=True)
    assert torch.equal(ca, cp_dev) and torch.equal(ca.cpu(), cp_cpu)
    esc = (_if == 255) & (torch.arange(64, device=dev) > 0)
    assert torch.equal(df[:, 0], ca[:, 0]) and torch.equal(df[esc], ca[esc])
    hi = fk._dct_quant_verify_plain(xp, sf, sf, n, cfg, False)[1]
    assert not torch.equal(ca, hi)  # the split is not the float32 product


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("n_valid", [5 * TILE_N - 11, 3 * CTA_N + 2048 - 11])
def test_relaxed_kernel_a_matches_plain(dev, mode, verify, n_valid):
    """A-relaxed and A-QT-relaxed against their plain version on the card:
    one launch of the RELAXED instantiation and none of the HIGHEST one;
    coefficients (EC) within RELAXED_BUDGET; verify off: the ids differ only
    near a bin edge (near_edge); verify on (a narrow signal that gives the
    repair work): the ids of at most 2 + nblk/100 blocks differ, the same
    verified flag, the decode of A's output within the tolerance where A
    says so, and the screen (1024 eps) flags at least the blocks it repairs,
    about as many as the plain version's. The HIGHEST arm's coefficients
    lie beyond the budget somewhere: the launch took the relaxed arm."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.core import transform
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode as fe

    x = _signal(n_valid, n_valid + 3, narrow=verify)
    if mode == "qt" and not verify:
        x = _qt_input(n_valid, n_valid + 3)
    xp = _padded_on(dev, x)
    sf, _ = api._stats_device(xp, n_valid, 1)
    q = fe.qtable_qmax(xp, sf, 1e-3, relaxed=True) if mode == "qt" else None
    tol = fe.tolerance(xp, n_valid, 1e-3)
    cfg = CodecConfig(mode=mode, error_bound=1e-3)
    ck = torch.zeros(2, dtype=torch.int64, device=dev)
    cp_ = torch.zeros(2, dtype=torch.int64, device=dev)
    fk.reset_launches()
    ik, vk, okk = fk.dct_quant_verify(xp, sf, tol, n_valid, 1e-3, verify, q, ck,
                                      relaxed=True)
    name = "dct_quant_verify_qt" if q is not None else "dct_quant_verify"
    assert fk.LAUNCHES[name + "_relaxed"] == 1 and fk.LAUNCHES[name] == 0
    ip, vp, okp = fk._dct_quant_verify_plain(xp, sf, tol, n_valid, cfg, verify, q, cp_,
                                             relaxed=True)
    budget = _budget(xp, sf)
    if not verify:
        coef_p = transform.block_dct((xp / sf).reshape(-1, 64), "high")
        _ids_differ_only_near_edges(ik, ip, coef_p, budget, cfg, q)
        if q is None:
            assert torch.all((vk - vp).abs() <= budget)
            hi = fk.dct_quant_verify(xp, sf, tol, n_valid, 1e-3, False)[1]
            assert bool(((vk - hi).abs() > budget).any())
        return
    assert int((ik != ip).any(1).sum()) <= 2 + ik.shape[0] // 100
    assert bool(okk) == bool(okp)
    ids_d = ik.clone()
    ids_d[:, 0] = 255
    esc = (ids_d == 255) & (torch.arange(64, device=dev) > 0)
    rec = fk.dequant_idct(ids_d, torch.where(esc, vk, torch.zeros_like(vk)),
                          vk[:, 0].contiguous(), sf, cfg, xp.numel(), q)
    if bool(okk):
        assert (rec - xp)[:n_valid].abs().max().item() <= tol.item()
    if q is None:
        assert torch.all((vk - vp).abs() <= budget)
    flagged, repaired = ck.tolist()
    flagged_p, missed_p = cp_.tolist()
    assert 0 < repaired <= flagged <= xp.numel() // 64
    assert abs(flagged - flagged_p) <= 1 + 0.02 * flagged_p
    assert abs(repaired - missed_p) <= 1 + 0.02 * missed_p


@pytest.mark.parametrize("n", [3 * 1024, 5 * TILE_N - 11] + TILE_EDGES)
def test_relaxed_kernel_e(dev, n):
    """E-relaxed: one launch of its RELAXED instantiation; the clamped
    maximum over the escaping coefficients of A-relaxed (EC, verify off:
    the coefficients A-QT-relaxed bins), bit for bit; within
    RELAXED_BUDGET of the block maxima of its plain version."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode as fe

    xp = _padded_on(dev, _qt_input(n, n + 11))
    sf, _ = api._stats_device(xp, n, 1)
    fk.reset_launches()
    got = fe.qtable_qmax(xp, sf, 1e-3, relaxed=True)
    assert fk.LAUNCHES["qtable_qmax_relaxed"] == 1 and fk.LAUNCHES["qtable_qmax"] == 0
    assert (got[1:] > 1.0).any() or n < TILE_N  # the shortest input has no spike escape
    _ids, coef, _ok = fk.dct_quant_verify(xp, sf, sf, n, 1e-3, False, relaxed=True)
    _w, rmin, rmax = qz._geometry(CodecConfig(error_bound=1e-3))
    esc = ~((coef >= rmin) & (coef <= rmax)) & (torch.arange(64, device=dev) > 0)
    from_a = torch.where(esc, coef.abs(), torch.zeros_like(coef)).amax(0)
    assert torch.equal(got, torch.clamp_min(from_a, 1.0))
    plain = torch.clamp_min(fe._qtable_qmax_plain(
        xp, sf, CodecConfig(mode="qt", error_bound=1e-3), relaxed=True), 1.0)
    assert torch.all((got - plain).abs() <= _budget(xp, sf).max())


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("n,kind", [(3 * TILE_N, "aligned"), (5 * TILE_N - 11, "aligned")]
                         + [(n, "aligned") for n in TILE_EDGES]
                         + [(5 * TILE_N - 11, "misaligned")])
def test_relaxed_kernels_f_g(dev, mode, n, kind):
    """F-relaxed and G-relaxed: one launch of the RELAXED instantiation;
    against their plain version, the ids differ only near a bin edge, DC
    and stored values within RELAXED_BUDGET (QT escapes: times
    eb*qt_factor/q[k], plus 4 ulp); against A-relaxed and A-QT-relaxed
    (verify off), the same ids at every AC position and the same values at
    DC and at the escapes, bit for bit (one routine, tile_product_bf16x3).
    Also on a misaligned view of the input."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.core import transform
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode as fe

    x = _qt_input(n, n + 13) if mode == "qt" else _signal(n, n + 13)
    xp = _padded_on(dev, x)
    sf, _ = api._stats_device(xp, n, 1)
    q = fe.qtable_qmax(xp, sf, 1e-3, relaxed=True) if mode == "qt" else None
    fk.reset_launches()
    ik, dk = fe.dct_quant(_off16(xp) if kind == "misaligned" else xp, sf, 1e-3, q,
                          relaxed=True)
    name = "dct_quant_qt" if q is not None else "dct_quant"
    assert fk.LAUNCHES[name + "_relaxed"] == 1 and fk.LAUNCHES[name] == 0
    cfg = CodecConfig(mode=mode, error_bound=1e-3)
    ip, dp = fe._dct_quant_plain(xp, sf, cfg, q, relaxed=True)
    budget = _budget(xp, sf)
    coef_p = transform.block_dct((xp / sf).reshape(-1, 64), "high")
    _ids_differ_only_near_edges(ik, ip, coef_p, budget, cfg, q)
    col = torch.arange(64, device=dev)
    esc = (ik == 255) & (col > 0)
    lim = budget.expand_as(dp)
    if q is not None:
        lim = torch.where(esc, budget * 1e-2 / q + 4 * 2.0**-23 * dp.abs(), lim)
    assert torch.all(((dk - dp).abs() <= lim)[ik == ip])
    ia, va, _ok = fk.dct_quant_verify(xp, sf, torch.ones((), device=dev), n, 1e-3,
                                      False, q, relaxed=True)
    assert esc.any() and torch.equal(ia[:, 1:], ik[:, 1:])
    assert torch.equal(va[esc].view(torch.int32), dk[esc].view(torch.int32))
    assert torch.equal(va[:, 0].view(torch.int32), dk[:, 0].view(torch.int32))


#: the routes of dct_precision="high" through the public API: (config
#: keywords, n, the relaxed kernels the compress must launch)
RELAXED_ROUTES = {
    "dpk_ec": (dict(container="v2", ids_codec="device", verify=True, segment_elems=0),
               5 * TILE_N - 11, {"dct_quant_verify_relaxed"}),
    "dpk_qt": (dict(mode="qt", container="v2", ids_codec="device", verify=True,
                    segment_elems=0), 5 * TILE_N - 11,
               {"qtable_qmax_relaxed", "dct_quant_verify_qt_relaxed"}),
    "dpk_ec_dtzs": (dict(container="v2", ids_codec="device", verify=True,
                         segment_elems=2 * TILE_N), 5 * TILE_N - 11,
                    {"dct_quant_verify_relaxed"}),
    "dpk_qt_verify_off": (dict(mode="qt", container="v2", ids_codec="device",
                               segment_elems=0), 3 * TILE_N,
                          {"qtable_qmax_relaxed", "dct_quant_verify_qt_relaxed"}),
    "v1_ec": (dict(verify=True), 3 * TILE_N, {"dct_quant_relaxed"}),
    "v1_qt": (dict(mode="qt", verify=True), 3 * TILE_N,
              {"qtable_qmax_relaxed", "dct_quant_qt_relaxed"}),
    "v1_ec_verify_off": (dict(), 3 * TILE_N, {"dct_quant_relaxed"}),
    "v1_generic": (dict(verify=True), 7777, set()),
    "v2_deflate": (dict(container="v2", ids_codec="deflate", verify=True, segment_elems=0),
                   3 * TILE_N + 128, {"dct_quant_relaxed"}),
}


@pytest.mark.parametrize("route", list(RELAXED_ROUTES))
def test_relaxed_round_trip_on_card(dev, route):
    """dz.compress with dct_precision="high" on every route: it launches the
    route's RELAXED kernels and none of the HIGHEST forward ones (the generic
    chain's product is transform.dot_bf16x3), holds the bound, matches the
    plain path's ratio within 0.1%, and the card and the plain path decode
    each other's containers within the bound."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.ops import dpk_fuse as fk

    kw, n, want = RELAXED_ROUTES[route]
    x = _qt_input(n, n + 17)
    cfg = dz.CodecConfig(error_bound=1e-3, dct_precision="high", **kw)
    fk.reset_launches()
    blob = dz.compress(x, config=cfg, device="cuda")
    launched = {k for k, v in fk.LAUNCHES.items() if v}
    assert want <= launched and not (launched & HIGHEST_FORWARD)
    assert not (launched & RELAXED) - want
    y = dz.decompress(blob, device="cuda")
    assert dz.evaluate(x, y, 1e-3)["bound_satisfied"]
    blob_cpu = dz.compress(x, config=cfg, device="cpu")
    assert abs(len(blob) / len(blob_cpu) - 1.0) <= 1e-3
    tol = 1e-3 * float(x.max() - x.min())
    assert np.abs(dz.decompress(blob_cpu, device="cuda") - x).max() <= tol
    assert np.abs(dz.decompress(blob, device="cpu") - x).max() <= tol


def test_relaxed_kernels_occupancy(dev):
    """The RELAXED instantiations do not spill; A's and A-QT's (71 KB of
    shared memory) fit 3 resident CTAs per SM, E's, F's and G's 4, as their
    HIGHEST instantiations do."""
    from dctz_tpu_torch.kernels import build

    build.lib()
    for k in ("dct_quant_verify", "dct_quant_verify_qt"):
        assert build.ctas_per_sm(k + "_relaxed") >= 3, k
    for k in ("qtable_qmax", "dct_quant", "dct_quant_qt"):
        assert build.ctas_per_sm(k + "_relaxed") >= 4, k
    spills = _ptxas_spills(build.PTXAS_LOG.read_text())
    for k in ("dct_quant_verify", "qtable_qmax", "dct_quant"):  # every instantiation
        assert spills.get(k) == 0, (k, spills.get(k))


#: float64 on the card: (config, length, the kernels the route launches).
#: Full width everywhere but "fast" (internal_dtype="float32"): the
#: generic chain in float64 torch ops with kernel H (v1, host-coded DTZS
#: frames) or kernel B, or J at chunk width 64 (DPK), and the decode's C or
#: I before the float64 dequantization and inverse transform; never D
F64_DPK = dict(error_bound=1e-3, container="v2", ids_codec="device", verify=True)
F64_ROUTES = {
    "v1_ec": (dict(error_bound=1e-3), 3 * TILE_N + 31,
              {"chunk_compact", "chunk_expand"}),
    "v1_qt_verify": (dict(error_bound=1e-3, mode="qt", verify=True), 3 * TILE_N,
                     {"chunk_compact", "chunk_expand"}),
    "dtzs": (dict(F64_DPK, segment_elems=2 * TILE_N), 4 * TILE_N + 1025,
             {"chunk_compact", "chunk_expand"}),
    "dtzs_qt": (dict(F64_DPK, mode="qt", segment_elems=2 * TILE_N), 4 * TILE_N + 1025,
                {"chunk_compact", "chunk_expand"}),
    "dpk": (dict(F64_DPK, segment_elems=0), 4 * TILE_N,
            {"dpk_pack_compact", "dpk_unpack_expand"}),
    "dpk_qt": (dict(F64_DPK, mode="qt", segment_elems=0), 4 * TILE_N - 5,
               {"dpk_pack_compact", "dpk_unpack_expand"}),
    "dpk_cw64": (dict(F64_DPK, segment_elems=0), 777,
                 {"chunk_compact_unified", "dpk_unpack_expand"}),
    "fast": (dict(F64_DPK, segment_elems=0, internal_dtype="float32"), 4 * TILE_N + 1025,
             {"dct_quant_verify", "dpk_pack_compact", "dpk_unpack_expand"}),
}


def _signal64(n, seed):
    rng = np.random.default_rng(seed)
    x = np.sin(np.arange(n) * 0.003) * 30.0 + rng.standard_normal(n) * 0.7
    x[::977] *= 30.0
    return x


#: tests/test_torch_oracle.py's MEAN_ULPS (that module imports jax): a
#: float32 header mean, a sum in another order, within this many ulp of
#: float32(mean |x|)
MEAN_ULPS = 4


def _same_f64_container(a: bytes, b: bytes, mean_tol: float | None = None) -> bool:
    """tests/test_torch_f64.py's rule without jax: every section and header
    field equal but the mean; a QT qtable within rtol 1e-15; frame by frame
    for a DTZS stream. mean_tol, where given, holds the means within it."""
    import dataclasses

    from dctz_tpu_torch import stream
    from dctz_tpu_torch.core import container as ct

    def frames(raw):
        if raw[:4] != b"DTZS":
            return [raw]
        off, out = stream._HDR.size, []
        while True:
            (flen,) = stream._FRAME.unpack_from(raw, off)
            off += stream._FRAME.size
            if not flen:
                return out
            out.append(raw[off: off + flen])
            off += flen

    def mean_of(f):
        return (ct.parse_v1(f) if ct.detect_format(f) == "v1" else ct.parse_v2(f))[0].mean

    def parse(f):
        if ct.detect_format(f) == "v1":
            h, *s, q = ct.parse_v1(f)
            return dataclasses.replace(h, mean=0.0), tuple(s), q
        h, s, q, cb = ct.parse_v2(f)
        return dataclasses.replace(h, mean=0.0), s + (cb,), q

    fa, fb = frames(a), frames(b)
    if len(fa) != len(fb):
        return False
    for x, y in zip(fa, fb):
        (ha, sa, qa), (hb, sb, qb) = parse(x), parse(y)
        if ha != hb or sa != sb or (qa is None) != (qb is None):
            return False
        if mean_tol is not None and abs(mean_of(x) - mean_of(y)) > mean_tol:
            return False
        if qa is not None and not np.allclose(qa, qb, rtol=1e-15, atol=0):
            return False
    return True


@pytest.mark.parametrize("route", list(F64_ROUTES))
def test_f64_route_on_card(dev, route):
    """Float64 through dz.compress and dz.decompress on the card: exactly
    the route's kernels launch (kernel D never), the decode is float64
    within the bound, and the container equals the CPU run's but for the
    mean. "fast" runs the float32 kernels, whose products differ from their
    plain versions', so it matches the CPU run's ratio within 0.1% instead."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import container as ct
    from dctz_tpu_torch.ops import dpk_fuse as fk

    kw, n, want = F64_ROUTES[route]
    x = _signal64(n, n)
    cfg = dz.CodecConfig(**kw)
    fk.reset_launches()
    blob = dz.compress(x, config=cfg, device="cuda")
    y = dz.decompress(blob, device="cuda")
    launched = {k for k, v in fk.LAUNCHES.items() if v}
    assert launched == want, launched
    assert y.dtype == np.float64 and dz.evaluate(x, y, 1e-3)["bound_satisfied"]
    blob_cpu = dz.compress(x, config=cfg, device="cpu")
    if route == "fast":
        assert ct.parse_v2(blob)[0].dtype == np.float64
        assert abs(len(blob) / len(blob_cpu) - 1.0) <= 1e-3
    else:
        assert _same_f64_container(blob, blob_cpu)
    tol = 1e-3 * float(x.max() - x.min())
    assert np.abs(dz.decompress(blob_cpu, device="cuda") - x).max() <= tol
    assert np.abs(dz.decompress(blob, device="cpu") - x).max() <= tol


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_f64_native_parity_on_card(dev, mode):
    """The card's float64 v1 container is the C++ codec's (cpp/), as
    tests/test_parity_native.py holds the JAX package's."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import native

    if not native.available():
        pytest.skip("native codec not built")
    x = np.random.default_rng(32799).standard_normal(32799) * 250
    assert _same_f64_container(dz.compress(x, 1e-3, mode, device="cuda"),
                               native.compress(x, 1e-3, mode))


# ---------------------------------------------------------------------------
# the codec options of ROADMAP item 9: brsf as kernel operands, and the
# gates that keep the other geometries off the kernels
# ---------------------------------------------------------------------------

BRSFS = [2 ** (3 / 8), 8.0]


@pytest.mark.parametrize("brsf", BRSFS)
@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_kernels_at_brsf(dev, mode, brsf):
    """A or A-QT (verify on), E and D or D-QT at a bin geometry scaled by
    brsf, each against its plain version as at brsf 1: ids within 1e-4,
    the same verified flag, coefficients within 32 ulp of max|x/sf| of the
    block (stored QT escapes within that times eb*qt_factor/q[k] plus 4
    ulp), E within 4 ulp, D within 32 ulp of sf * max|coef| of the block."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode as fe

    n_valid = 5 * TILE_N - 11
    xp = _padded_on(dev, _qt_input(n_valid, 41))
    sf, _ = api._stats_device(xp, n_valid, 1)
    tol = fe.tolerance(xp, n_valid, 1e-3)
    cfg = CodecConfig(mode=mode, error_bound=1e-3, brsf=brsf)
    q = None
    fk.reset_launches()
    if mode == "qt":
        q = fe.qtable_qmax(xp, sf, 1e-3, brsf=brsf)
        q_p = torch.clamp_min(fe._qtable_qmax_plain(xp, sf, cfg), 1.0)
        assert torch.all((q - q_p).abs() <= 4 * 2.0**-23 * torch.maximum(q, q_p))
    ik, vk, okk = fk.dct_quant_verify(xp, sf, tol, n_valid, 1e-3, True, q, brsf=brsf)
    assert fk.LAUNCHES["dct_quant_verify_qt" if q is not None else "dct_quant_verify"] == 1
    ip, vp, okp = fk._dct_quant_verify_plain(xp, sf, tol, n_valid, cfg, True, q)
    assert (ik != ip).float().mean().item() <= 1e-4
    assert bool(okk) == bool(okp)
    budget = 32 * 2.0**-23 * (xp / sf).reshape(-1, 64).abs().amax(1, keepdim=True)
    col = torch.arange(64, device=dev)
    esc = (ik == ip) & (ik == 255) & (col > 0)
    assert esc.sum().item() > 0
    lim = budget.expand_as(vp)
    if q is not None:
        lim = torch.where(esc, budget * 1e-2 / q + 4 * 2.0**-23 * vp.abs(), lim)
    assert torch.all(((vk - vp).abs() <= lim) | (ik != ip))
    # D on A's output: the escapes hold A's stored values, DC its coefficient
    ids = torch.where(col > 0, ik, torch.full_like(ik, 255))
    acv = torch.where((ids == 255) & (col > 0), vk, torch.zeros_like(vk))
    dc = vk[:, 0].contiguous()
    n_pad = xp.numel()
    xd = fk.dequant_idct(ids, acv, dc, sf, cfg, n_pad, q)
    xd_p = fk._dequant_idct_plain(ids, acv, dc, sf, cfg, n_pad, q)
    co = qz.decode_dense(ids, dc, acv, n_pad, cfg, q)
    lim_d = (32 * 2.0**-23 * sf * co.abs().amax(1)).repeat_interleave(64)
    assert torch.all((xd - xd_p).abs() <= lim_d)
    tol_x = 1e-3 * float((xp[:n_valid].max() - xp[:n_valid].min()).item())
    assert (xd[:n_valid] - xp[:n_valid]).abs().max().item() <= tol_x


@pytest.mark.parametrize("bs,nblk,launches_j", [(128, 1024, True), (32, 4096, True),
                                                (48, 2730, True), (48, 2735, False),
                                                (128, 1027, True)])
def test_kernel_j_at_block_size(dev, bs, nblk, launches_j):
    """pack_ids_with_ac at a block size other than 64 (the XLA chain's DPK
    route): kernel J where it takes the chunk width, a multiple of 32
    (block sizes 128 and 32 at these counts, and 48 at an even count of
    240-sample rows: rows of 480), torch ops elsewhere (48 at an odd count:
    rows of 240), the plain version's bytes either way."""
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import idpack

    rng = np.random.default_rng(bs + nblk)
    mag = rng.geometric(p=0.4, size=(nblk, bs)).astype(np.int64) - 1
    ids = np.minimum(mag * 8 // np.maximum(1, np.arange(bs) // 4)[None, :], 254)
    ids = np.where(rng.random((nblk, bs)) < 0.02, 255, ids).astype(np.uint8)
    ids[:, 0] = 255
    vals = rng.standard_normal((nblk, bs)).astype(np.float32)
    it, vt = torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev)
    cw = qz.chunk_width(nblk * bs, bs)
    assert (cw % 32 == 0) == launches_j
    fk.reset_launches()
    got = idpack.pack_ids_with_ac(it, vt, nblk * bs - 5, 256, 128)
    launched = {k for k, v in fk.LAUNCHES.items() if v}
    assert launched == ({"chunk_compact_unified"} if launches_j else set())
    ref = idpack.pack_ids_with_ac(it.cpu(), vt.cpu(), nblk * bs - 5, 256, 128)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g.cpu(), r)


#: the item-9 routes through the public API on the card: (config, input
#: length, float64 input, kernels that must launch, kernels that must not)
ITEM9_ROUTES = {
    "ec_auto_dtzs": (dict(F64_DPK, rate="auto", segment_elems=2 * TILE_N), 5 * TILE_N - 11,
                     False, {"dct_quant_verify", "dpk_pack_compact", "dpk_unpack_expand",
                             "dequant_idct"}, {"dct_quant"}),
    "qt_auto": (dict(F64_DPK, mode="qt", rate="auto", segment_elems=0), 5 * TILE_N - 11,
                False, {"qtable_qmax", "dct_quant_verify_qt", "dpk_pack_compact",
                        "dpk_unpack_expand", "dequant_idct_qt"}, {"dct_quant_qt"}),
    "deflate_brsf": (dict(container="v2", ids_codec="deflate", segment_elems=0,
                          verify=True, brsf=2.0), 4 * TILE_N, False,
                     {"chunk_compact", "chunk_expand", "dequant_idct"},
                     {"dct_quant", "dct_quant_verify"}),
    "dpk_bs128": (dict(F64_DPK, block_size=128, segment_elems=0), 4 * TILE_N - 3, False,
                  {"chunk_compact_unified", "chunk_expand"},
                  {"dct_quant_verify", "dpk_pack_compact", "dpk_unpack_expand",
                   "dequant_idct"}),
    "deflate_nbins63": (dict(container="v2", ids_codec="deflate", segment_elems=0,
                             verify=True, nbins=63), 4 * TILE_N, False,
                        {"chunk_compact", "chunk_expand"},
                        {"dequant_idct", "dct_quant", "dct_quant_verify"}),
    "v1_f64_full": (dict(truncate=False), 3 * TILE_N, True, set(),
                    {"chunk_compact", "chunk_expand", "dequant_idct"}),
    "dtzs_f64_full": (dict(F64_DPK, truncate=False, segment_elems=2 * TILE_N),
                      4 * TILE_N + 1025, True, set(),
                      {"chunk_compact", "chunk_expand", "dequant_idct"}),
}


@pytest.mark.parametrize("route", list(ITEM9_ROUTES))
def test_item9_route_on_card(dev, route):
    """rate="auto", brsf, a non-default geometry and truncate=False through
    dz.compress and dz.decompress on the card: the route's kernels launch
    and the kernels its gates exclude do not, the bound holds, the card
    and the plain path pick the same brsf and match in ratio within 0.1%,
    and each decodes the other's container within the bound."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import container as ct
    from dctz_tpu_torch.ops import dpk_fuse as fk

    kw, n, f64, want, never = ITEM9_ROUTES[route]
    x = _signal64(n, n) if f64 else _qt_input(n, n)
    cfg = dz.CodecConfig(**dict(dict(error_bound=1e-3), **kw))
    fk.reset_launches()
    blob = dz.compress(x, config=cfg, device="cuda")
    y = dz.decompress(blob, device="cuda")
    launched = {k for k, v in fk.LAUNCHES.items() if v}
    assert want <= launched and not (launched & never), launched
    assert y.dtype == x.dtype and dz.evaluate(x, y, 1e-3)["bound_satisfied"]
    blob_cpu = dz.compress(x, config=cfg, device="cpu")
    assert abs(len(blob) / len(blob_cpu) - 1.0) <= 1e-3

    def head(b):
        f = b if b[:4] != b"DTZS" else b[24:24 + int.from_bytes(b[16:24], "little")]
        return ct.parse_v1(f)[0] if ct.detect_format(f) == "v1" else ct.parse_v2(f)[0]

    assert head(blob).brsf == head(blob_cpu).brsf
    tol = 1e-3 * float(x.max() - x.min())
    assert np.abs(dz.decompress(blob_cpu, device="cuda") - x).max() <= tol
    assert np.abs(dz.decompress(blob, device="cpu") - x).max() <= tol


# ---------------------------------------------------------------------------
# the drivers (ROADMAP item 11): the CLI and the evaluation harness, whose
# default device is the card
# ---------------------------------------------------------------------------

#: CLI cases: the dtype flag, the input's dtype, the options beyond the
#: protocol's positionals
CLI_CARD = {
    "f32_v1": ("-f", np.float32, []),
    "f32_dpk": ("-f", np.float32, ["--container", "v2", "--ids-codec", "device",
                                   "--verify"]),
    "f64_v1": ("-d", np.float64, ["--verify"]),
}


@pytest.mark.parametrize("case", list(CLI_CARD))
def test_cli_on_card_matches_cpu(dev, tmp_path, capsys, case):
    """dctz_tpu_torch.cli at its default device, the card, on 1Mi samples:
    the .z equals the --device cpu run's but for the header's mean (a sum in
    another order; a float32 one within MEAN_ULPS), the JSON line's metrics
    but the timings equal, the card's .z.r the CPU's bit for bit, and the
    .z.r within the bound where verify is on."""
    import json

    from dctz_tpu_torch.cli import main

    flag, dtype, extra = CLI_CARD[case]
    n = 1 << 20
    x = _signal64(n, 7).astype(dtype)
    runs = {}
    for device in ("cuda", "cpu"):
        d = tmp_path / device
        d.mkdir()
        x.tofile(d / "v.bin")
        argv = [flag, "1E-3", "v", str(d / "v.bin"), str(n), "--json"] + extra
        assert main(argv + (["--device", "cpu"] if device == "cpu" else [])) == 0
        m = json.loads(capsys.readouterr().out.splitlines()[-2])
        runs[device] = (m, (d / "v.bin.ec.1E-3.z").read_bytes(),
                        np.fromfile(d / "v.bin.ec.1E-3.z.r", dtype))
    (mg, zg, rg), (mc, zc, rc) = runs["cuda"], runs["cpu"]
    mean_tol = (MEAN_ULPS * float(np.spacing(np.float32(np.abs(x).mean())))
                if dtype == np.float32 else None)
    assert _same_f64_container(zg, zc, mean_tol)
    clocks = {"compress_s", "decompress_s", "mb_per_s_compress", "mb_per_s_decompress"}
    assert list(mg) == list(mc)
    assert {k: v for k, v in mg.items() if k not in clocks} == {
        k: v for k, v in mc.items() if k not in clocks}
    assert rg.dtype == rc.dtype == dtype
    assert np.array_equal(rg, rc)
    if "--verify" in extra:
        assert mg["bound_satisfied"]
        assert np.abs(rg.astype(np.float64) - x).max() <= 1e-3 * float(x.max() - x.min())


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("which", ["msst19", "f32"])
def test_harness_rows_on_card_match_cpu(dev, which, mode):
    """harness.run_one at its default device, the card: the row equals the
    CPU run's in every field but the two speeds (msst19's first entry,
    float64; a 70001-sample float32 entry, the generic chain)."""
    from dctz_tpu_torch.eval import harness
    from dctz_tpu_torch.eval.datasets import MSST19, Dataset

    ds = MSST19[0] if which == "msst19" else Dataset("toy", (70001,), "f32", "climate")
    got = harness.run_one(ds, 1e-3, mode)
    want = harness.run_one(ds, 1e-3, mode, device="cpu")
    speeds = ("compress_mb_s", "decompress_mb_s")
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k not in speeds} == {
        k: v for k, v in want.items() if k not in speeds}
    assert got["compressor"] == f"dctz_{mode}_torch" and got["bound_satisfied"]


# ---------------------------------------------------------------------------
# multi-GPU (ROADMAP item 10): the sharded paths on a mesh of one card
# ---------------------------------------------------------------------------

#: compress_sharded configurations: (config, QT input, kernels that launch
#: once a shard on encode (A and B again on a full-width retry; the chain's
#: H for the AC rows and the id exceptions), on decode)
SHARDED_CARD = {
    "ec_dpk": (dict(F64_DPK), False, {"dct_quant_verify", "dpk_pack_compact"},
               {"dpk_unpack_expand", "dequant_idct"}),
    "qt_dpk": (dict(F64_DPK, mode="qt"), True, {"chunk_compact"},
               {"dpk_unpack_expand", "dequant_idct_qt"}),
    "ec_deflate": (dict(F64_DPK, ids_codec="deflate"), False, {"chunk_compact"},
                   {"chunk_expand", "dequant_idct"}),
}
#: 4 shards of 2 tiles, the last one holding the padding
SHARDED_N = 8 * TILE_N - 777


@pytest.mark.parametrize("case", list(SHARDED_CARD))
def test_sharded_mesh_on_card(dev, case):
    """compress_sharded on ["cuda:0"] * 4 against ["cpu"] * 4: the same
    container but for the mean (ec_dpk: kernels A and B, whose containers
    have equalled their plain versions' on every card run) or, where the
    chain's transform is a cuBLAS product (qt_dpk, ec_deflate), the ratio
    within 0.1% and each decoding the other within the bound; every kernel
    of the path once a shard; decompress_sharded equal to decompress of
    the same container, and within the bound."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.ops import dpk_fuse as fk

    kw, qt_input, enc_k, dec_k = SHARDED_CARD[case]
    x = _qt_input(SHARDED_N, 5) if qt_input else _signal(SHARDED_N, 5)
    cfg = dz.CodecConfig(**kw)
    fk.reset_launches()
    blob = dz.compress_sharded(x, config=cfg, mesh=["cuda:0"] * 4)
    enc = {k: v for k, v in fk.LAUNCHES.items() if v}
    fk.reset_launches()
    y = dz.decompress_sharded(blob, mesh=["cuda:0"] * 4)
    dec = {k: v for k, v in fk.LAUNCHES.items() if v}
    assert set(enc) == enc_k and all(v % 4 == 0 for v in enc.values()), enc
    if case == "ec_dpk":
        assert enc["dct_quant_verify"] == enc["dpk_pack_compact"]
    assert dec == {k: 4 for k in dec_k}, dec
    assert np.array_equal(y, dz.decompress(blob, device="cuda"))
    tol = 1e-3 * float(x.max() - x.min())
    assert np.abs(y - x).max() <= tol
    blob_cpu = dz.compress_sharded(x, config=cfg, mesh=["cpu"] * 4)
    if case == "ec_dpk":
        mean_tol = MEAN_ULPS * float(np.spacing(np.float32(np.abs(x).mean())))
        assert _same_f64_container(blob, blob_cpu, mean_tol)
    assert abs(len(blob) / len(blob_cpu) - 1.0) <= 1e-3
    assert np.abs(dz.decompress_sharded(blob_cpu, mesh=["cuda:0"] * 2) - x).max() <= tol
    assert np.abs(dz.decompress_sharded(blob, mesh=["cpu"] * 4) - x).max() <= tol


def test_sharded_device_input_on_card(dev, monkeypatch):
    """A CUDA tensor is padded and split on the card (Tensor.cpu, .numpy
    and .tolist raise meanwhile), and writes the numpy input's container."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.parallel import sharding as sh

    x = _signal(SHARDED_N, 6)
    x_dev = torch.from_numpy(x).to(dev)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("cpu", "numpy", "tolist"):
            mp.setattr(torch.Tensor, name, lambda *_a, **_k: pytest.fail("host copy"))
        shards, n_pad = sh.shard_input_device(x_dev, sh.make_mesh(["cuda:0"] * 4), 64, 256)
    assert n_pad == 8 * TILE_N and all(s.is_cuda and s.numel() == 2 * TILE_N for s in shards)
    cfg = dz.CodecConfig(**F64_DPK)
    mesh = ["cuda:0"] * 4
    assert dz.compress_sharded(x_dev, config=cfg, mesh=mesh) == dz.compress_sharded(
        x, config=cfg, mesh=mesh)


def test_two_gloo_ranks_on_card(dev, tmp_path):
    """Two ranks on the one card (gloo: NCCL refuses two ranks on one
    GPU), each with the mesh ["cuda:0"]: the write's parts decode within
    the bound, and a two-rank restore gives each rank its own frame, equal
    to the full decode's slice."""
    import dctz_tpu_torch as dz
    from test_torch_multihost import _restored, _run, make_data

    n = 64 * 1200 + 7
    x = make_data(n)
    parts = _run(tmp_path, "torch", 2, n, "ec", "device", mesh="cuda:0")
    stream = b"".join(p.read_bytes() for p in parts)
    y = dz.decompress(stream, device="cuda")
    assert y.dtype == np.float64 and np.abs(y - x).max() <= 1e-3 * float(x.max() - x.min())
    path = tmp_path / "stream.bin"
    path.write_bytes(stream)
    for r, (start, frames, data) in enumerate(
            _restored(_run(tmp_path, "torch", 2, n, "restore", "device", path,
                           mesh="cuda:0"))):
        assert frames == (r,) and np.array_equal(data, y[start : start + data.size])


# ---------------------------------------------------------------------------
# robustness and soak (tests/test_torch_robustness.py, test_torch_soak.py)
# on the card
# ---------------------------------------------------------------------------

#: the decode kernels a corrupted container must never reach: C, D, D-QT, I
DECODE_KERNELS = ("dpk_unpack_expand", "dequant_idct", "dequant_idct_qt", "chunk_expand")
#: flipped positions decoded on the card per container (a seeded sample)
CARD_FLIPS = 256
#: the robustness fixtures' configurations (tests/test_torch_robustness.py):
#: input, CodecConfig keyword arguments (None: dz.compress(x, 1e-3, "ec"))
FLIP_CARD = {
    "v1": ("f64", None),
    "v2_deflate": ("f64", dict(error_bound=1e-3, container="v2", ids_codec="deflate")),
    "dpk": ("f32", dict(error_bound=1e-3, container="v2", ids_codec="device")),
    "dtzs": ("dtzs", dict(error_bound=1e-3, container="v2", ids_codec="device",
                          segment_elems=1 << 15)),
}


@pytest.mark.parametrize("fmt", list(FLIP_CARD))
def test_flipped_containers_raise_before_the_kernels(dev, fmt):
    """Byte-flipped copies (XOR 0x5A) of a v1, a host-coded v2, a DPK v2
    container and a two-frame DPK DTZS stream written on the card, decoded
    on the card at CARD_FLIPS seeded positions (torch_common.flip_positions;
    a v1 container's checked bytes only): each decode raises a clean
    exception, and no decode kernel (C, D, D-QT, I) launches on a corrupted
    container: the header and chunk crcs (a v1 container's length fields
    and zlib streams) are checked on the host first. A DTZS stream's intact
    frames before the flip decode as usual (frames_intact_before), no
    launch beyond theirs. Then the good container decodes bit-equal to its
    first decode: the CUDA context survived."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from torch_common import V1_UNCHECKED, flip_positions, frames_intact_before, frames_of

    inp, kw = FLIP_CARD[fmt]
    x = {"f64": np.sin(np.linspace(0, 30, 5000)),
         "f32": np.sin(np.linspace(0, 30, 5000)).astype(np.float32),
         "dtzs": np.sin(np.linspace(0, 300, 2 << 15)).astype(np.float32)}[inp]
    blob = (dz.compress(x, 1e-3, "ec", device="cuda") if kw is None
            else dz.compress(x, config=dz.CodecConfig(**kw), device="cuda"))
    assert (blob[:4] == b"DTZS") == (fmt == "dtzs")
    fk.reset_launches()
    y0 = dz.decompress(blob, device="cuda")
    per_frame = {k: fk.LAUNCHES[k] // len(frames_of(blob)) for k in DECODE_KERNELS}
    assert any(per_frame.values()), per_frame
    positions = [p for p in flip_positions(blob) if fmt != "v1" or p not in V1_UNCHECKED]
    rng = np.random.default_rng(len(blob))
    for pos in sorted(rng.choice(positions, min(CARD_FLIPS, len(positions)), replace=False)):
        b = bytearray(blob)
        b[pos] ^= 0x5A
        fk.reset_launches()
        with pytest.raises(Exception) as ei:
            dz.decompress(bytes(b), device="cuda")
        assert not isinstance(ei.value, (SystemExit, MemoryError)), (pos, ei.value)
        intact = frames_intact_before(blob, int(pos)) if fmt == "dtzs" else 0
        over = {k: fk.LAUNCHES[k] for k in DECODE_KERNELS
                if fk.LAUNCHES[k] > intact * per_frame[k]}
        assert not over, (pos, intact, over)
    torch.cuda.synchronize()
    assert np.array_equal(dz.decompress(blob, device="cuda"), y0)


def _generic_f32(x, kw) -> bool:
    """A float32 v1 container whose length is not a multiple of 1024: the
    generic chain, whose forward transform is a torch matmul (cuBLAS on the
    card, the CPU's BLAS there), not one of the kernels."""
    return x.dtype == np.float32 and kw["container"] == "v1" and x.size % 1024 != 0


def _card_mean_ulps(n: int) -> float:
    """The float32 header mean's budget between the card and the CPU, in
    ulp of mean |x|: two float32 sums of n terms in other orders (the card's
    torch.sum, the CPU's), each within ceil(log2 n) eps of sum |x| as a
    pairwise sum is (5 ulp seen at n = 6221, beyond MEAN_ULPS' 4 for XLA
    against the CPU; the decoder never reads the mean)."""
    return 2.0 * np.ceil(np.log2(max(n, 2)))


def _assert_same_but_edge_flips(card, cpu, x):
    """Two float32 v1 containers of the generic chain: the same header but
    for the mean (_card_mean_ulps), the AC count and the sections' sizes,
    and the same ids but at bin-edge flips (at most 1e-4 of the positions,
    and one): a coefficient within the two products' ulps of a bin edge."""
    import dataclasses

    from dctz_tpu_torch import api
    from torch_common import assert_mean_close

    ha, _qa, (ids_a, *_), _ = api._host_stage(card)
    hb, _qb, (ids_b, *_), _ = api._host_stage(cpu)
    assert_mean_close(ha, hb, x, _card_mean_ulps(x.size))
    keep = dict(mean=0.0, ac_count=0, bindex_nbytes=0, dc_nbytes=0, ac_nbytes=0)
    assert dataclasses.replace(ha, **keep) == dataclasses.replace(hb, **keep)
    assert ids_a.shape == ids_b.shape
    assert int((ids_a != ids_b).sum()) <= max(1, 1e-4 * ids_a.size)


@pytest.mark.parametrize("seed", range(4))
def test_soak_configs_on_card_match_cpu(dev, seed):
    """tests/test_soak.py's random configurations (torch_common.
    roundtrip_configs) on the card against the CPU twin. Containers: byte
    for byte as test_torch_oracle.assert_byte_equal holds the port's to
    the reference's (torch_common: the DPK frames of kernel A allowed their
    bin-edge flips against the plain version, the float32 mean within
    _card_mean_ulps, a float64 QT qtable within rtol 1e-15 of two float64
    arithmetics), but for the generic chain's float32 v1 containers
    (_generic_f32: the same header and ids but at bin-edge flips). Decodes
    of the card's container: the card's equal to the CPU's on the float32
    kernel routes, else within the transforms' budget (32 eps32, or
    tests/test_torch_f64.py's 8 eps64, times max|y|): the float64 decode
    and the generic chain run torch products. The round trip and the
    cross decodes hold the soak's bound."""
    import dctz_tpu_torch as dz
    from torch_common import assert_byte_equal, roundtrip_configs, soak_rel_ok

    for x, kw in roundtrip_configs(seed):
        cfg = dz.CodecConfig(**kw)
        card = dz.compress(x, config=cfg, device="cuda")
        cpu = dz.compress(x, config=cfg, device="cpu")
        generic = _generic_f32(x, kw)
        if generic:
            _assert_same_but_edge_flips(card, cpu, x)
        else:
            assert_byte_equal(card, cpu, x, edge_flips=True, qtable_rtol=1e-15,
                              mean_ulps=_card_mean_ulps(x.size))
        y = dz.decompress(card, device="cuda")
        y_cpu = dz.decompress(card, device="cpu")
        assert y.dtype == x.dtype and y.shape == x.shape, kw
        if x.dtype == np.float32 and not generic:
            assert np.array_equal(y, y_cpu), kw
        else:
            k = 8 if x.dtype == np.float64 else 32
            lim = k * np.finfo(x.dtype).eps * float(np.abs(y_cpu).max())
            assert float(np.abs(y.astype(np.float64) - y_cpu).max()) <= lim, kw
        assert soak_rel_ok(x, y, kw), kw
        assert soak_rel_ok(x, dz.decompress(cpu, device="cuda"), kw), kw


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scaling_factor_on_card_equals_cpu(dev, dtype):
    """The scaling factor, 10**(ceil(log10(amax)) - sf_adj), of an amax on
    the card equals the CPU's for every decade of the dtype's normal range
    and sf_adj 0, 1 and 3 (the card's own float64 pow gave
    9.999999999999999e-06 for 10**-5, where the CPU and dctz_tpu give
    1e-05: another header and another divisor of every sample)."""
    from dctz_tpu_torch.core.stats import scaling_factor

    fi = np.finfo(dtype)
    ks = range(int(np.ceil(np.log10(fi.tiny))), int(np.floor(np.log10(fi.max))))
    amax = np.array([m * 10.0 ** k for k in ks for m in (0.5, 1.0, 3.7)], dtype)
    amax = amax[np.isfinite(amax) & (amax >= fi.tiny)]
    for adj in (0, 1, 3):
        for a in amax:
            t = torch.tensor(a, dtype=getattr(torch, np.dtype(dtype).name))
            got = scaling_factor(t.to(dev), adj)
            assert got.device.type == "cuda"
            assert got.cpu().item() == scaling_factor(t, adj).item(), (a, adj)


@pytest.mark.parametrize("path", ["dtzs", "mono"])
def test_syncs_counted_equal_sync_debug_mode(dev, path):
    """The program's own count of its host-blocking waits in one compress
    and one decompress (StageTimer.counts["syncs"]) equals what torch's sync
    debug mode finds in the same call (bench._syncs_in): the DTZS path of a
    CUDA tensor (EC, four frames) and the monolithic QT container of a host
    array. The copies' bytes are counted beside them."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import bench
    from dctz_tpu_torch.utils.timing import StageTimer

    x = _signal(4 * TILE_N, 21)
    cfg = dz.CodecConfig(mode="ec" if path == "dtzs" else "qt", container="v2",
                         ids_codec="device", verify=True,
                         segment_elems=TILE_N if path == "dtzs" else 0)
    inp = torch.from_numpy(x).to(dev) if path == "dtzs" else x
    blob = dz.compress(inp, config=cfg, device=dev)  # warm: kernels, basis
    dz.decompress(blob, device=dev)
    tc, td = StageTimer(), StageTimer()
    found_c = bench._syncs_in(
        lambda: dz.compress(inp, config=cfg, timer=tc, device=dev), dev)
    found_d = bench._syncs_in(
        lambda: dz.decompress(blob, timer=td, device=dev), dev)
    for timer, found in ((tc, found_c), (td, found_d)):
        where = [(s.name, timer.spans[s.parent].name) for s in timer.spans
                 if s.name == "sync"]
        assert timer.counts["syncs"] == len(found), (timer.counts, found, where)
    if path == "dtzs":
        assert tc.counts["frames"] == td.counts["frames"] == 4
        assert tc.counts["bytes_d2h_pinned"] > 0
        assert td.counts["bytes_d2h_pageable"] >= x.nbytes
    else:
        assert tc.counts["bytes_h2d_pageable"] >= x.nbytes
        assert td.counts["bytes_d2h_pageable"] >= x.nbytes
