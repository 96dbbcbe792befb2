"""The one-pass DPK decode at any tile: kernel M (port of
dctz_tpu/ops/research/fused_decode.py).

DPK streams to samples in one launch (csrc/fused_decode_dpk.cu): unpack at
tile b, exception and AC expansion, dequantization (EC, or QT through the
container's qtable), inverse DCT and unscale, 64 blocks at a time in shared
memory. At b = 256 it decodes the bits of kernels C + D (EC) and C + D-QT
(QT) (ops/dpk_fuse.decode_fused). walk_of says which of its two
instantiations a geometry takes. Nothing in api calls it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...config import CodecConfig
from ...core import constants as C
from ...core import quantize as qz
from ...core import transform
from .. import compaction as cp
from .. import dpk_fuse, idpack

BS = 64  # DCT block size (container invariant)
MAX_B = 256  # kernel M: blocks per tile, at most
_LO = 16  # capacities are multiples of the JAX kernel's 16-wide rank digit

def _is_f32(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    return np.dtype(dtype) == np.float32


def eligible(work_dtype, bs: int, b: int, cw: int, cape: int, capc: int) -> bool:
    """The JAX kernel's geometry gate: float32, 64-sample blocks, an even
    tile b whose elements split into whole chunk rows of cw (a block
    multiple), and capacities that are multiples of 16 up to 128. Kernel M
    also needs b <= MAX_B (fused_decode_dpk raises beyond)."""
    return (
        _is_f32(work_dtype)
        and bs == BS
        and b % 2 == 0
        and cw % bs == 0
        and (b * bs) % cw == 0
        and 0 < cape <= 128
        and 0 < capc <= 128
        and cape % _LO == 0
        and capc % _LO == 0
    )


def walk_of(b: int, cw: int) -> str:
    """Which instantiation of kernel M decodes tile b at chunk width cw:
    "words", the 512-sample warp steps of csrc/dpk_walk.cuh (b a multiple of
    8, cw a power of two), else "lanes", one warp per chunk row ranking 32
    samples a step (csrc/fused_decode_dpk.cu:word_walk)."""
    return "words" if b % 8 == 0 and cw >= BS and cw & (cw - 1) == 0 else "lanes"


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.nn.functional.pad(a, (0, 0, 0, rows - a.shape[0])) if a.shape[0] < rows else a


def _coefficients_plain(width, packed, exc_rows, dc, ac_rows, b, cw, cfg, qtable):
    """The (T*b, 64) coefficient grid kernel M inverts, on the tile-padded
    grid: idpack.unpack_ids at tile b, expand_rows of the escapes,
    quantize.decode_dense."""
    nb = width.shape[0] * b
    rows = nb * BS // cw
    ids = idpack.unpack_ids(width, packed, _pad_rows(exc_rows, rows), nb, BS, b, cw,
                            plain=True)
    esc = ids == C.ESCAPE
    esc[:, 0] = False
    acv = cp.expand_rows(esc.reshape(-1, cw),
                         _pad_rows(ac_rows.to(torch.float32), rows)).reshape(nb, BS)
    dcp = torch.nn.functional.pad(dc.to(torch.float32), (0, nb - dc.shape[0]))
    return qz.decode_dense(ids, dcp, acv, nb * BS, cfg, qtable)


def _fused_decode_dpk_plain(width, packed, exc_rows, dc, ac_rows, sf, n_stream,
                            b, cw, cfg, qtable):
    """Kernel M's plain version: _coefficients_plain, transform.block_idct,
    * sf."""
    co = _coefficients_plain(width, packed, exc_rows, dc, ac_rows, b, cw, cfg, qtable)
    return (transform.block_idct(co) * sf).reshape(-1)[:n_stream]


def fused_decode_dpk(width, packed, exc_rows, dc, ac_rows, sf, n_stream: int,
                     b: int, cw: int, cfg: CodecConfig,
                     qtable: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel M. Replaces the TPU kernel
    dctz_tpu/ops/research/fused_decode.py:fused_decode_dpk (line 313,
    pallas_call at line 380).

    width (T, 64) per-tile-position widths; packed (T*64, b//2) u8 capacity
    rows; exc_rows (nc, cape) u8 and ac_rows (nc, capc) f32 chunk rows (nc
    may stop short of T*b*64/cw: missing rows read as zeros); dc (>= nblk,)
    f32; sf float32 scalar tensor; n_stream a multiple of 64; QT when
    cfg.mode == "qt" and a qtable is given. Returns flat float32
    (n_stream,). Raises ValueError for a geometry that eligible() refuses
    and, on the card, for a tile of more than MAX_B blocks."""
    return _decode(width, packed, exc_rows, dc, ac_rows, sf, n_stream, b, cw, cfg,
                   qtable, functools.partial(dpk_fuse._launch, "fused_decode_dpk"))


def _decode(width, packed, exc_rows, dc, ac_rows, sf, n_stream, b, cw, cfg, qtable,
            launch):
    """fused_decode_dpk with `launch(*args)` as the card's kernel: kernel
    M's C entry point, or its card-only reference's (ops/research/_ref.py),
    bound to its name. CPU tensors take the plain version."""
    if n_stream % BS:
        raise ValueError(f"n_stream {n_stream} is not a multiple of {BS}")
    cape, capc = exc_rows.shape[1], ac_rows.shape[1]
    if not eligible(torch.float32, BS, b, cw, cape, capc):
        raise ValueError(f"geometry b={b} cw={cw} cape={cape} capc={capc} "
                         f"is not eligible")
    qt_mode = cfg.mode == "qt" and qtable is not None
    if not qt_mode:
        qtable = None
    args = (width, packed, exc_rows, dc, ac_rows, sf) + ((qtable,) if qt_mode else ())
    if not dpk_fuse._on_cuda(*args):
        return _fused_decode_dpk_plain(width, packed, exc_rows, dc, ac_rows, sf,
                                       n_stream, b, cw, cfg, qtable)
    if b > MAX_B:
        raise ValueError(f"tile of {b} blocks: kernel M takes at most {MAX_B} "
                         f"blocks per tile")
    nblk = n_stream // BS
    t = width.shape[0]
    width = width.to(torch.uint8).contiguous()
    ac_rows = ac_rows.to(torch.float32).contiguous()
    dc = dc.to(torch.float32).contiguous()
    dpk_fuse._check(packed, torch.uint8, "packed")
    packed = dpk_fuse._aligned16(packed)  # M reads its rows in 32-bit words
    dpk_fuse._check(exc_rows, torch.uint8, "exc_rows")
    if (width.shape[1:] != (BS,) or packed.shape != (t * BS, b // 2)
            or t * b < nblk or dc.shape[0] < nblk
            or exc_rows.shape[0] > t * b * BS // cw
            or ac_rows.shape[0] > t * b * BS // cw):
        raise ValueError("unsupported DPK geometry or layout")
    dev = width.device
    out = torch.empty((nblk * BS,), dtype=torch.float32, device=dev)
    if nblk == 0:
        return out
    w, rmin, rmax = qz._geometry(cfg)
    q32 = dpk_fuse._qtable32(qtable) if qt_mode else None
    sf32 = sf.reshape(1).to(torch.float32).contiguous()
    basis = transform.dct2_basis(BS, dev)
    launch(
        width.data_ptr(), packed.data_ptr(),
        exc_rows.data_ptr(), ac_rows.data_ptr(), dc.data_ptr(), basis.data_ptr(),
        sf32.data_ptr(), None if q32 is None else q32.data_ptr(), nblk,
        exc_rows.shape[0], ac_rows.shape[0], b, cw, cape, capc, w, rmin, rmax,
        qz.qt_denom(cfg) if qt_mode else 1.0, int(qt_mode), out.data_ptr(),
    )
    return out
