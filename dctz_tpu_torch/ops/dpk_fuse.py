"""The DPK EC encode and decode as four hand-written CUDA kernels.

Port of dctz_tpu/ops/dpk_fuse.py. The JAX package runs each direction as ONE
Pallas program (encode_x_fused, decode_fused); the port splits each into two
launches so that the integer stages stay byte-comparable with their plain
versions (fusing them back is later work):

  encode_x_fused = A dct_quant_verify  (scale, DCT, bins, verify-repair)
                 + B dpk_pack_compact  (widths, bit packing, compaction, DC)
  decode_fused   = C dpk_unpack_expand (unpack, exception and AC expansion)
                 + D dequant_idct      (bin centers, DC, IDCT, unscale)

Every kernel has a wrapper here that takes the plain PyTorch version for
tensors on the CPU, and launches the kernel (csrc/*.cu, built at first use by
kernels/build.py) for CUDA tensors, or raises. It never falls back. The
wrappers count their launches in LAUNCHES, only where a kernel launches.

Plain versions, composed from the ported modules:
  A: core.transform.block_dct + core.quantize.encode_ids + ops.repair
  B: ops.idpack.pack_ids_with_ac
  C: ops.idpack.unpack_ids + ops.compaction.expand_chunked
  D: core.quantize.decode_dense + core.transform.block_idct
"""

from __future__ import annotations

import torch

from ..config import CodecConfig
from ..core import constants as C
from ..core import quantize as qz
from ..core import transform
from . import compaction as cp
from . import idpack
from . import repair

BS = 64  # DCT block size
TILE_B = 256  # blocks per DPK tile (idpack.B_DEFAULT)
TILE_N = TILE_B * BS  # elements per tile

#: launches of each kernel by its wrapper (plain versions do not count)
LAUNCHES = {
    "dct_quant_verify": 0,
    "dpk_pack_compact": 0,
    "dpk_unpack_expand": 0,
    "dequant_idct": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for all-CUDA inputs, False for all-CPU; raises on anything else."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"inputs on mixed or unsupported devices: {kinds}")


def _check(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(name: str, *args) -> None:
    from ..kernels import build

    fn = getattr(build.lib(), "dctz_" + name)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
    LAUNCHES[name] += 1


def _ceil_lanes(c: int) -> int:
    return -(-c // 128) * 128


# ---------------------------------------------------------------------------
# A. dct_quant_verify
# ---------------------------------------------------------------------------


def _dct_quant_verify_plain(x, sf, tol, n_valid, cfg, verify):
    n_pad = x.shape[0]
    xs = x / sf  # divide: reference semantics
    coef = transform.block_dct(xs.reshape(-1, BS))
    ids = qz.encode_ids(coef, n_pad, cfg)
    ok = torch.ones((), dtype=torch.bool, device=x.device)
    if verify:
        ids, ok = repair.verify_repair(
            x, coef, sf, ids, coef[:, 0], n_pad, n_valid, cfg, tol
        )
    acm = qz.ac_mask(ids.shape[0], BS, n_pad, x.device)
    ids = torch.where(acm, ids, torch.zeros_like(ids)).to(torch.uint8)
    return ids, coef, ok


def dct_quant_verify(x, sf, tol, n_valid: int, cfg_eb: float, verify: bool):
    """Kernel A. Replaces the transform and verify half of
    dctz_tpu/ops/dpk_fuse.py:_make_encode_x_kernel (lines 494-647).

    x: flat float32 (n_pad,), n_pad a multiple of 1024; sf, tol: float32
    scalars on x's device. Returns (ids u8 (n_pad/64, 64) zeroed at DC and
    padding, coef f32 (n_pad/64, 64), ok bool scalar tensor)."""
    cfg = CodecConfig(error_bound=cfg_eb)
    n_pad = x.shape[0]
    if not _on_cuda(x, sf, tol):
        return _dct_quant_verify_plain(x, sf, tol, n_valid, cfg, verify)
    _check(x, torch.float32, "x")
    if x.dim() != 1 or n_pad % 1024:
        raise ValueError(f"x must be flat with a length that is a multiple "
                         f"of 1024, got shape {tuple(x.shape)}")
    w, rmin, rmax = qz._geometry(cfg)
    nblk = n_pad // BS
    t = -(-n_pad // TILE_N)
    ids = torch.empty((nblk, BS), dtype=torch.uint8, device=x.device)
    coef = torch.empty((nblk, BS), dtype=torch.float32, device=x.device)
    ok_tiles = torch.empty((t,), dtype=torch.int32, device=x.device)
    sf32 = sf.reshape(1).to(torch.float32).contiguous()
    tol32 = tol.reshape(1).to(torch.float32).contiguous()
    basis = transform.dct2_basis(BS, x.device)
    _launch(
        "dct_quant_verify", x.data_ptr(), basis.data_ptr(), sf32.data_ptr(),
        tol32.data_ptr(), n_pad, n_valid, rmin, rmax, w, int(bool(verify)),
        ids.data_ptr(), coef.data_ptr(), ok_tiles.data_ptr(),
    )
    return ids, coef, torch.all(ok_tiles != 0)


# ---------------------------------------------------------------------------
# B. dpk_pack_compact
# ---------------------------------------------------------------------------


def _dpk_pack_compact_plain(ids2d, vals2d, n_valid: int, cape_k: int):
    return idpack.pack_ids_with_ac(ids2d, vals2d, n_valid, TILE_B, cape_k)[:7]


def dpk_pack_compact(ids2d, vals2d, n_valid: int, cape_k: int, cw: int):
    """Kernel B. Replaces dctz_tpu/ops/dpk_fuse.py:_pack_tile (lines
    288-418) with shuffle.route_compact_unified; its contract is
    idpack.pack_ids_with_ac and dpk_fuse.encode_fused.

    ids2d u8 / vals2d f32 (nblk, 64). Returns (width (T,64) u8, packed
    (T*64,128) u8, exc (nc,cape_k) u8, exc_counts (nc,) i32, ac (nc,cape_k)
    f32, ac_counts (nc,) i32, dc (nblk,) f32) with nc = nblk*64/cw."""
    nblk, bs = ids2d.shape
    if not _on_cuda(ids2d, vals2d):
        return _dpk_pack_compact_plain(ids2d, vals2d, n_valid, cape_k)
    _check(ids2d, torch.uint8, "ids")
    _check(vals2d, torch.float32, "vals")
    if (bs != BS or vals2d.shape != ids2d.shape or cw % BS or TILE_N % cw
            or (nblk * BS) % cw or not 0 < cape_k <= cw):
        raise ValueError(f"unsupported geometry {tuple(ids2d.shape)} "
                         f"cw={cw} cape={cape_k}")
    t = -(-nblk // TILE_B)
    cpt = TILE_N // cw
    nc = nblk * BS // cw
    dev = ids2d.device
    width = torch.empty((t, BS), dtype=torch.uint8, device=dev)
    packed = torch.empty((t * BS, 128), dtype=torch.uint8, device=dev)
    exc = torch.empty((t * cpt, cape_k), dtype=torch.uint8, device=dev)
    ac = torch.empty((t * cpt, cape_k), dtype=torch.float32, device=dev)
    exc_counts = torch.empty((t * cpt,), dtype=torch.int32, device=dev)
    ac_counts = torch.empty((t * cpt,), dtype=torch.int32, device=dev)
    dc = torch.empty((t * TILE_B,), dtype=torch.float32, device=dev)
    _launch(
        "dpk_pack_compact", ids2d.data_ptr(), vals2d.data_ptr(), nblk, n_valid,
        cw, cape_k, width.data_ptr(), packed.data_ptr(), exc.data_ptr(),
        ac.data_ptr(), exc_counts.data_ptr(), ac_counts.data_ptr(),
        dc.data_ptr(),
    )
    return (width, packed, exc[:nc], exc_counts[:nc], ac[:nc],
            ac_counts[:nc], dc[:nblk])


def encode_fused(ids2d, dcac2d, n_valid: int, b: int, cape: int, cw: int):
    """Same contract as dctz_tpu/ops/dpk_fuse.py:encode_fused: kernel B with
    the capacity rounded up to a lane multiple and sliced back. Returns
    (width, packed, exc_rows, exc_counts, ac_rows, ac_counts, dc, overflow)."""
    assert b == TILE_B
    cape = min(cape, cw)
    cape_k = min(cw, _ceil_lanes(cape))
    width, packed, exc, exc_counts, ac, ac_counts, dc = dpk_pack_compact(
        ids2d, dcac2d, n_valid, cape_k, cw
    )
    return (width, packed, exc[:, :cape], exc_counts, ac[:, :cape],
            ac_counts, dc, torch.any(exc_counts > cape))


def encode_x_fused(x, sf, tol, n_valid: int, cfg_eb: float, cape: int,
                   cw: int, verify: bool):
    """Whole EC encode from raw samples: kernel A then kernel B. Same
    contract as dctz_tpu/ops/dpk_fuse.py:encode_x_fused (EC mode). Returns
    (width, packed, exc_rows, exc_counts, ac_rows, ac_counts, dc, overflow,
    ok)."""
    n_pad = x.shape[0]
    ids, coef, ok = dct_quant_verify(x, sf, tol, n_valid, cfg_eb, verify)
    return encode_fused(ids, coef, n_pad, TILE_B, cape, cw) + (ok,)


# ---------------------------------------------------------------------------
# C. dpk_unpack_expand
# ---------------------------------------------------------------------------


def _dpk_unpack_expand_plain(width, packed, exc_rows, ac_rows, nblk,
                             n_stream, cw):
    ids = idpack.unpack_ids(width, packed, exc_rows, nblk, BS, TILE_B, cw)
    esc = qz.ac_mask(nblk, BS, n_stream, ids.device) & (ids == C.ESCAPE)
    acv = cp.expand_chunked(esc.reshape(-1, cw), ac_rows.to(torch.float32))
    return ids, acv.reshape(nblk, BS)


def dpk_unpack_expand(width, packed, exc_rows, ac_rows, nblk: int,
                      n_stream: int, cw: int):
    """Kernel C. Replaces the unpack and routing half of
    dctz_tpu/ops/dpk_fuse.py:_make_kernel (lines 116-210,
    shuffle.route_expand); contract idpack.unpack_ids plus the AC expansion.

    Returns (ids u8 (nblk, 64) with DC = ESCAPE, acv f32 (nblk, 64): the AC
    value at every escape, 0 elsewhere)."""
    if not _on_cuda(width, packed, exc_rows, ac_rows):
        return _dpk_unpack_expand_plain(
            width, packed, exc_rows, ac_rows, nblk, n_stream, cw
        )
    _check(width, torch.uint8, "width")
    _check(packed, torch.uint8, "packed")
    _check(exc_rows, torch.uint8, "exc_rows")
    _check(ac_rows, torch.float32, "ac_rows")
    t = width.shape[0]
    nc = exc_rows.shape[0]
    if (width.shape[1] != BS or packed.shape != (t * BS, 128) or cw % BS
            or TILE_N % cw or t != -(-nblk // TILE_B) or nc * cw != nblk * BS
            or ac_rows.shape[0] != nc or packed.data_ptr() % 16):
        raise ValueError("unsupported DPK geometry or layout")
    dev = width.device
    ids = torch.empty((nblk, BS), dtype=torch.uint8, device=dev)
    acv = torch.empty((nblk, BS), dtype=torch.float32, device=dev)
    _launch(
        "dpk_unpack_expand", width.data_ptr(), packed.data_ptr(),
        exc_rows.data_ptr(), ac_rows.data_ptr(), nblk, nc, n_stream, cw,
        exc_rows.shape[1], ac_rows.shape[1], ids.data_ptr(), acv.data_ptr(),
    )
    return ids, acv


# ---------------------------------------------------------------------------
# D. dequant_idct
# ---------------------------------------------------------------------------


def _dequant_idct_plain(ids, acv, dc, sf, cfg: CodecConfig, n_stream: int):
    co = qz.decode_dense(ids, dc, acv, ids.shape[0] * BS, cfg)
    x = (transform.block_idct(co) * sf).reshape(-1)
    n_full, rem = divmod(n_stream, BS)
    if rem:
        last = qz.decode_dense(ids[n_full:], dc[n_full:], acv[n_full:], rem,
                               cfg)
        tail = transform.block_idct(last[0, :rem][None])[0]
        x[n_full * BS : n_stream] = tail * sf
    return x


def dequant_idct(ids, acv, dc, sf, cfg: CodecConfig, n_stream: int):
    """Kernel D. Replaces the dequantize and IDCT half of
    dctz_tpu/ops/dpk_fuse.py:_make_kernel (lines 220-260).

    ids u8 / acv f32 (nblk, 64), dc f32 (nblk,), sf float32 scalar tensor;
    returns flat float32 (nblk*64,) whose first n_stream samples are the
    decode. A length that is not a block multiple (the JAX package's
    XLA-chain containers store the true length) decodes its last block
    through the rem-point basis, as that chain does."""
    nblk = ids.shape[0]
    if not _on_cuda(ids, acv, dc, sf):
        return _dequant_idct_plain(ids, acv, dc, sf, cfg, n_stream)
    w, _, _ = qz._geometry(cfg)
    _check(ids, torch.uint8, "ids")
    _check(acv, torch.float32, "acv")
    _check(dc, torch.float32, "dc")
    if ids.shape[1:] != (BS,) or acv.shape != ids.shape or dc.shape[0] < nblk:
        raise ValueError("ids/acv must be (nblk, 64) and dc hold nblk values")
    if -(-n_stream // BS) != nblk:
        raise ValueError(f"n_stream {n_stream} does not fill {nblk} blocks")
    rem = n_stream % BS
    out = torch.empty((nblk * BS,), dtype=torch.float32, device=ids.device)
    sf32 = sf.reshape(1).to(torch.float32).contiguous()
    basis = transform.dct2_basis(BS, ids.device)
    tail_ptr = transform.dct2_basis(rem, ids.device).data_ptr() if rem else None
    _launch(
        "dequant_idct", ids.data_ptr(), acv.data_ptr(), dc.data_ptr(),
        basis.data_ptr(), tail_ptr, sf32.data_ptr(), nblk, rem, w,
        out.data_ptr(),
    )
    return out


def decode_fused(width, packed, exc_rows, ac_rows, dc, sf, cfg: CodecConfig,
                 cw: int, n_stream: int) -> torch.Tensor:
    """Decode of a DPK EC container's device arrays: kernel C then kernel D
    -> flat float32 (n_stream,)."""
    nblk = -(-n_stream // BS)
    ids, acv = dpk_unpack_expand(width, packed, exc_rows, ac_rows, nblk,
                                 n_stream, cw)
    return dequant_idct(ids, acv, dc, sf, cfg, n_stream)[:n_stream]
