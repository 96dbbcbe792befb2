"""The DPK EC/QT encode and decode as hand-written CUDA kernels.

Port of dctz_tpu/ops/dpk_fuse.py. The JAX package runs each direction as ONE
Pallas program (encode_x_fused, decode_fused); the port splits each into two
launches so that the integer stages stay byte-comparable with their plain
versions (fusing them back is later work):

  encode_x_fused = A dct_quant_verify  (scale, DCT, bins, verify-repair)
                 + B dpk_pack_compact  (widths, bit packing, compaction, DC)
  decode_fused   = C dpk_unpack_expand (unpack, exception and AC expansion)
                 + D dequant_idct      (bin centers, DC, IDCT, unscale)

QT mode (a qtable argument) launches the QT instantiations of A and D
(dct_quant_verify_qt, dequant_idct_qt): A renormalizes escapes through the
qtable and hands B the stored values, D inverts the renormalization. B and C
do not depend on the mode. The qtable itself comes from kernel E
(ops/fused_encode.qtable_qmax).

relaxed=True (CodecConfig.dct_precision "high") launches A's RELAXED
instantiations (dct_quant_verify_relaxed, dct_quant_verify_qt_relaxed): the
analysis is three bfloat16 products on the tensor cores and the L2 screen's
budget is 1024 eps * max|xs| (the TPU kernel's relaxed arm); the
reconstructions stay float32. Their plain version runs
transform.block_dct(.., "high").

Every kernel has a wrapper here that takes the plain PyTorch version for
tensors on the CPU, and launches the kernel (csrc/*.cu, built at first use by
kernels/build.py) for CUDA tensors, or raises. It never falls back. The
wrappers count their launches in LAUNCHES, only where a kernel launches.

Plain versions, composed from the ported modules:
  A: core.transform.block_dct + core.quantize.encode_ids(_qt) + ops.repair
  B: ops.idpack._pack_ids_with_ac_plain
  C: ops.idpack.unpack_ids(plain=True) + ops.compaction.expand_rows
  D: core.quantize.decode_dense + core.transform.block_idct
  E: ops.fused_encode._qtable_qmax_plain
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
#: elements per CUDA block tile of kernels A, D, E, F and G
#: (csrc/dct_tile.cuh); A reports one verify flag per such tile
CTA_N = 64 * BS
EPS32 = 2.0**-23
#: kernel A's L2-screen rounding budget, in eps * max|xs| of the block: the
#: HIGHEST analysis, and the relaxed one (dpk_fuse.py:603-607)
SCREEN_BUDGET = {False: 32.0, True: 1024.0}

#: launches of each kernel by its wrapper (plain versions do not count)
LAUNCHES = {
    "qtable_qmax": 0,
    "dct_quant_verify": 0,
    "dct_quant_verify_qt": 0,
    "dpk_pack_compact": 0,
    "dpk_unpack_expand": 0,
    "dequant_idct": 0,
    "dequant_idct_qt": 0,
    # the non-DPK containers' kernels (ops/fused_encode.py, ops/shuffle.py)
    "dct_quant": 0,
    "dct_quant_qt": 0,
    "chunk_compact": 0,
    "chunk_expand": 0,
    # kernels J, K (ops/shuffle.py) and L, M (ops/research/)
    "chunk_compact_unified": 0,
    "chunk_compact_bytes": 0,
    "fused_encode_dpk": 0,
    "fused_decode_dpk": 0,
    # the RELAXED instantiations (dct_precision "high") of A, A-QT, E, F, G
    "dct_quant_verify_relaxed": 0,
    "dct_quant_verify_qt_relaxed": 0,
    "qtable_qmax_relaxed": 0,
    "dct_quant_relaxed": 0,
    "dct_quant_qt_relaxed": 0,
}


#: launches of each instantiation of kernels H, J and K (ops/shuffle.walk_of):
#: the word walk under the kernel's name, the lane walk with "_lanes";
#: LAUNCHES counts both under the kernel's name
INSTANTIATIONS = {
    "chunk_compact": 0,
    "chunk_compact_lanes": 0,
    "chunk_compact_unified": 0,
    "chunk_compact_unified_lanes": 0,
    "chunk_compact_bytes": 0,
    "chunk_compact_bytes_lanes": 0,
}


def encode_eligible(b: int, bs: int, cw: int, nbins: int = C.NBINS) -> bool:
    """The geometry kernels A and B take (dctz_tpu/ops/dpk_fuse.py:278-285):
    tiles of 256 blocks of 64 samples, 255 bins (csrc/common.cuh: NBINS),
    a chunk width that is a multiple of 128 and divides the tile."""
    return (b == TILE_B and bs == BS and nbins == C.NBINS and cw % 128 == 0
            and TILE_N % cw == 0)


def decode_eligible(cfg: CodecConfig, tile_b: int, cw: int) -> bool:
    """Whether kernel C takes a DPK container's ids and AC rows: the
    default geometry (default_geometry, as dctz_tpu's decode_eligible at
    dctz_tpu/ops/dpk_fuse.py:72-83 asks), tiles of 256 blocks, and C's own
    chunk-width limit, a block multiple that divides the tile (the JAX
    package's kernel asks a multiple of 128, a limit of the TPU's vector
    layout; C unpacks the same ids either way)."""
    return (default_geometry(cfg) and tile_b == TILE_B and cw % BS == 0
            and TILE_N % cw == 0)


def default_geometry(cfg: CodecConfig) -> bool:
    """Blocks of 64 samples and 255 bins, which kernels A-G hard-code
    (csrc/common.cuh, csrc/dct_tile.cuh); brsf is an operand."""
    return cfg.block_size == BS and cfg.nbins == C.NBINS


def reset_launches() -> None:
    for counts in (LAUNCHES, INSTANTIATIONS):
        for k in counts:
            counts[k] = 0


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


def _launch(name: str, *args, instantiation: str | None = None) -> None:
    from ..kernels import build

    fn = getattr(build.lib(), "dctz_" + name)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
    LAUNCHES[name] += 1
    if instantiation is not None:
        INSTANTIATIONS[instantiation] += 1


def _precision(relaxed: bool) -> str:
    """The transform's precision name (core/transform.py) of an arm."""
    return "high" if relaxed else "highest"


def _arm(relaxed: bool) -> str:
    """The suffix of a kernel's RELAXED instantiation in LAUNCHES and in the
    library's entry points."""
    return "_relaxed" if relaxed else ""


def _ceil_lanes(c: int) -> int:
    return -(-c // 128) * 128


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes (kernels
    A-G move 16 bytes a thread; only a view into another tensor can be
    off)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ---------------------------------------------------------------------------
# A. dct_quant_verify
# ---------------------------------------------------------------------------


def _mode_cfg(cfg_eb: float, qtable, brsf: float = 1.0) -> CodecConfig:
    return CodecConfig(mode="ec" if qtable is None else "qt", error_bound=cfg_eb,
                       brsf=brsf)


def _qtable32(qtable: torch.Tensor) -> torch.Tensor:
    if qtable.shape != (BS,):
        raise ValueError(f"qtable must be ({BS},), got {tuple(qtable.shape)}")
    return qtable.to(torch.float32).contiguous()


def _screen_counts(x, coef, ids, sf, tol, n_valid, cfg, qtable,
                   relaxed: bool = False):
    """(blocks kernel A's L2 screen sends to the exact check, blocks whose
    reconstruction misses tol before the repair), as A's counters count
    them, with the screen's budget of the analysis (SCREEN_BUDGET); sums
    and transforms in torch's order, so a block at the screen's edge may
    count differently."""
    n_pad = x.shape[0]
    acm = qz.ac_mask(ids.shape[0], BS, n_pad, x.device)
    dense = repair.stored_dense(coef, ids, acm, cfg, qtable)
    hat = qz.decode_dense(ids, coef[:, 0], dense, n_pad, cfg, qtable)
    l2 = ((hat - coef) ** 2).sum(1)
    thr = tol / sf - SCREEN_BUDGET[relaxed] * EPS32 * (x / sf).reshape(
        -1, BS).abs().amax(1)
    flagged = (l2 > thr * thr) | (thr <= 0)
    err = ((transform.block_idct(hat) * sf).reshape(-1) - x).abs()
    err = torch.where(torch.arange(n_pad, device=x.device) < n_valid, err,
                      torch.zeros_like(err))
    missed = err.reshape(-1, BS).amax(1) > tol
    return int(flagged.sum()), int(missed.sum())


def _dct_quant_verify_plain(x, sf, tol, n_valid, cfg, verify, qtable=None,
                            counters=None, relaxed: bool = False):
    n_pad = x.shape[0]
    xs = x / sf  # divide: reference semantics
    coef = transform.block_dct(xs.reshape(-1, BS), _precision(relaxed))
    if qtable is None:
        ids = qz.encode_ids(coef, n_pad, cfg)
    else:
        ids = qz.encode_ids_qt(coef, n_pad, cfg, qtable)
    ok = torch.ones((), dtype=torch.bool, device=x.device)
    if verify:
        if counters is not None:
            counters += torch.tensor(
                _screen_counts(x, coef, ids, sf, tol, n_valid, cfg, qtable,
                               relaxed),
                dtype=counters.dtype, device=counters.device)
        ids, ok = repair.verify_repair(
            x, coef, sf, ids, coef[:, 0], n_pad, n_valid, cfg, tol, qtable
        )
    acm = qz.ac_mask(ids.shape[0], BS, n_pad, x.device)
    vals = repair.stored_dense(coef, ids, acm, cfg, qtable)
    ids = torch.where(acm, ids, torch.zeros_like(ids)).to(torch.uint8)
    return ids, vals, ok


def dct_quant_verify(x, sf, tol, n_valid: int, cfg_eb: float, verify: bool,
                     qtable: torch.Tensor | None = None,
                     counters: torch.Tensor | None = None, *,
                     relaxed: bool = False, brsf: float = 1.0):
    """Kernel A. Replaces the transform and verify half of
    dctz_tpu/ops/dpk_fuse.py:_make_encode_x_kernel (lines 494-647), in its
    HIGHEST arm or, relaxed, in its relaxed one (the instantiations named
    with _relaxed).

    x: flat float32 (n_pad,), n_pad a multiple of 1024; sf, tol: float32
    scalars on x's device; qtable: the (64,) quantizer table for QT mode
    (its slot 0 is not read), None for EC. Returns (ids u8 (n_pad/64, 64)
    zeroed at DC and padding, vals f32 (n_pad/64, 64), ok bool scalar
    tensor). vals holds the coefficients, except at QT's AC escapes, which
    hold the renormalized values the container stores. brsf scales the bins
    (w, rmin, rmax from qz._geometry, runtime operands of the kernel).
    counters: None (the
    codec's path), or an int64 (2,) tensor on x's device to which a
    verifying call adds the blocks the L2 screen sent to the exact check and
    the blocks whose reconstruction missed tol and were repaired."""
    cfg = _mode_cfg(cfg_eb, qtable, brsf)
    n_pad = x.shape[0]
    args = [t for t in (x, sf, tol, qtable, counters) if t is not None]
    if counters is not None:
        _check(counters, torch.int64, "counters")
        if counters.shape != (2,):
            raise ValueError(f"counters must be (2,), got {tuple(counters.shape)}")
    if not _on_cuda(*args):
        return _dct_quant_verify_plain(x, sf, tol, n_valid, cfg, verify, qtable,
                                       counters, relaxed)
    _check(x, torch.float32, "x")
    if x.dim() != 1 or n_pad % 1024:
        raise ValueError(f"x must be flat with a length that is a multiple "
                         f"of 1024, got shape {tuple(x.shape)}")
    x = _aligned16(x)
    w, rmin, rmax = qz._geometry(cfg)
    nblk = n_pad // BS
    ids = torch.empty((nblk, BS), dtype=torch.uint8, device=x.device)
    vals = torch.empty((nblk, BS), dtype=torch.float32, device=x.device)
    ok_tiles = torch.empty((-(-n_pad // CTA_N),), dtype=torch.int32,
                           device=x.device)
    sf32 = sf.reshape(1).to(torch.float32).contiguous()
    tol32 = tol.reshape(1).to(torch.float32).contiguous()
    basis = transform.dct2_basis(BS, x.device)
    head = (x.data_ptr(), basis.data_ptr(), sf32.data_ptr(), tol32.data_ptr())
    tail = (n_pad, n_valid, rmin, rmax, w, int(bool(verify)), ids.data_ptr(),
            vals.data_ptr(), ok_tiles.data_ptr(),
            None if counters is None else counters.data_ptr())
    arm = _arm(relaxed)
    if qtable is None:
        _launch("dct_quant_verify" + arm, *head, *tail)
    else:
        q32 = _qtable32(qtable)
        _launch("dct_quant_verify_qt" + arm, *head, q32.data_ptr(),
                float(cfg.error_bound), float(cfg.qt_factor), *tail)
    return ids, vals, torch.all(ok_tiles != 0)


# ---------------------------------------------------------------------------
# B. dpk_pack_compact
# ---------------------------------------------------------------------------


def _dpk_pack_compact_plain(ids2d, vals2d, n_valid: int, cape_k: int,
                            cw: int | None = None):
    return idpack._pack_ids_with_ac_plain(ids2d, vals2d, n_valid, TILE_B,
                                          cape_k, cw)[:7]


def dpk_pack_compact(ids2d, vals2d, n_valid: int, cape_k: int, cw: int):
    """Kernel B. Replaces dctz_tpu/ops/dpk_fuse.py:_pack_tile (lines
    288-418) with shuffle.route_compact_unified; its contract is
    idpack.pack_ids_with_ac and dpk_fuse.encode_fused.

    ids2d u8 / vals2d f32 (nblk, 64). Returns (width (T,64) u8, packed
    (T*64,128) u8, exc (nc,cape_k) u8, exc_counts (nc,) i32, ac (nc,cape_k)
    f32, ac_counts (nc,) i32, dc (nblk,) f32) with nc = nblk*64/cw."""
    nblk, bs = ids2d.shape
    if not _on_cuda(ids2d, vals2d):
        return _dpk_pack_compact_plain(ids2d, vals2d, n_valid, cape_k, cw)
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
    ids2d, vals2d = _aligned16(ids2d), _aligned16(vals2d)
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
                   cw: int, verify: bool, qtable: torch.Tensor | None = None,
                   *, relaxed: bool = False, brsf: float = 1.0):
    """Whole EC/QT encode from raw samples: kernel A then kernel B. Same
    contract as dctz_tpu/ops/dpk_fuse.py:encode_x_fused; a qtable selects QT
    mode, relaxed the relaxed analysis (its dct_precision="high"), brsf the
    bin geometry. Returns (width, packed, exc_rows, exc_counts, ac_rows,
    ac_counts, dc, overflow, ok)."""
    n_pad = x.shape[0]
    ids, vals, ok = dct_quant_verify(x, sf, tol, n_valid, cfg_eb, verify,
                                     qtable, relaxed=relaxed, brsf=brsf)
    return encode_fused(ids, vals, n_pad, TILE_B, cape, cw) + (ok,)


# ---------------------------------------------------------------------------
# C. dpk_unpack_expand
# ---------------------------------------------------------------------------


def _dpk_unpack_expand_plain(width, packed, exc_rows, ac_rows, nblk,
                             n_stream, cw):
    ids = idpack.unpack_ids(width, packed, exc_rows, nblk, BS, TILE_B, cw,
                            plain=True)
    esc = qz.ac_mask(nblk, BS, n_stream, ids.device) & (ids == C.ESCAPE)
    acv = cp.expand_rows(esc.reshape(-1, cw), ac_rows.to(torch.float32))
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
    width, exc_rows, ac_rows = map(_aligned16, (width, exc_rows, ac_rows))
    _launch(
        "dpk_unpack_expand", width.data_ptr(), packed.data_ptr(),
        exc_rows.data_ptr(), ac_rows.data_ptr(), nblk, nc, n_stream, cw,
        exc_rows.shape[1], ac_rows.shape[1], ids.data_ptr(), acv.data_ptr(),
    )
    return ids, acv


# ---------------------------------------------------------------------------
# D. dequant_idct
# ---------------------------------------------------------------------------


def _dequant_idct_plain(ids, acv, dc, sf, cfg: CodecConfig, n_stream: int,
                        qtable=None):
    co = qz.decode_dense(ids, dc, acv, ids.shape[0] * BS, cfg, qtable)
    x = (transform.block_idct(co) * sf).reshape(-1)
    n_full, rem = divmod(n_stream, BS)
    if rem:
        last = qz.decode_dense(ids[n_full:], dc[n_full:], acv[n_full:], rem,
                               cfg, qtable)
        tail = transform.block_idct(last[0, :rem][None])[0]
        x[n_full * BS : n_stream] = tail * sf
    return x


def dequant_idct(ids, acv, dc, sf, cfg: CodecConfig, n_stream: int,
                 qtable: torch.Tensor | None = None):
    """Kernel D. Replaces the dequantize and IDCT half of
    dctz_tpu/ops/dpk_fuse.py:_make_kernel (lines 212-260).

    ids u8 / acv f32 (nblk, 64), dc f32 (nblk,), sf float32 scalar tensor;
    qtable: the container's (64,) quantizer table in QT mode (escapes are
    renormalized values, inverted before the IDCT), None for EC. Returns
    flat float32 (nblk*64,) whose first n_stream samples are the decode. A
    length that is not a block multiple (the JAX package's XLA-chain
    containers store the true length) decodes its last block through the
    rem-point basis, as that chain does."""
    nblk = ids.shape[0]
    args = (ids, acv, dc, sf) + (() if qtable is None else (qtable,))
    if not _on_cuda(*args):
        return _dequant_idct_plain(ids, acv, dc, sf, cfg, n_stream, qtable)
    w, rmin, rmax = qz._geometry(cfg)
    _check(ids, torch.uint8, "ids")
    _check(acv, torch.float32, "acv")
    _check(dc, torch.float32, "dc")
    if ids.shape[1:] != (BS,) or acv.shape != ids.shape or dc.shape[0] < nblk:
        raise ValueError("ids/acv must be (nblk, 64) and dc hold nblk values")
    if -(-n_stream // BS) != nblk:
        raise ValueError(f"n_stream {n_stream} does not fill {nblk} blocks")
    rem = n_stream % BS
    ids, acv = _aligned16(ids), _aligned16(acv)
    out = torch.empty((nblk * BS,), dtype=torch.float32, device=ids.device)
    sf32 = sf.reshape(1).to(torch.float32).contiguous()
    basis = transform.dct2_basis(BS, ids.device)
    tail_ptr = transform.dct2_basis(rem, ids.device).data_ptr() if rem else None
    head = (ids.data_ptr(), acv.data_ptr(), dc.data_ptr(), basis.data_ptr(),
            tail_ptr, sf32.data_ptr(), nblk, rem, w)
    if qtable is None:
        _launch("dequant_idct", *head, out.data_ptr())
    else:
        q32 = _qtable32(qtable)
        _launch("dequant_idct_qt", *head, q32.data_ptr(), rmin, rmax,
                qz.qt_denom(cfg), out.data_ptr())
    return out


def decode_fused(width, packed, exc_rows, ac_rows, dc, sf, cfg: CodecConfig,
                 cw: int, n_stream: int,
                 qtable: torch.Tensor | None = None) -> torch.Tensor:
    """Decode of a DPK EC/QT container's device arrays: kernel C then
    kernel D -> flat float32 (n_stream,). A qtable selects QT mode."""
    nblk = -(-n_stream // BS)
    ids, acv = dpk_unpack_expand(width, packed, exc_rows, ac_rows, nblk,
                                 n_stream, cw)
    return dequant_idct(ids, acv, dc, sf, cfg, n_stream, qtable)[:n_stream]
