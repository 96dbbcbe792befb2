"""Device coding of the bin-id stream, "DPK" (port of dctz_tpu/ops/idpack.py).

Per tile of B = 256 blocks and per coefficient position, the nibbles
min(id, 15) pack at the width w in 0..4 that minimises w*B + 8*#exceptions
(first minimum wins); nibbles >= 2^w - 1 pack as that marker and their
original id byte goes to the exception stream, compacted in block-major
chunk rows like the AC stream. _pack_ids_with_ac_plain is kernel B's twin
and unpack_ids(plain=True) the id half of kernel C's twin (ops/dpk_fuse.py);
unpack_ids expands its exception bytes through compaction.expand_chunked
(kernel I where it applies).
pack_ids_with_ac dispatches as the JAX package does: kernel B at B's
geometry, kernel J (ops/shuffle.compact_unified) at any other tile or block
size whose chunk width J takes (compaction.kernel_eligible), for CUDA
tensors, and torch ops elsewhere; pack_ids compacts its exception bytes through
compaction.compact_chunked (kernel H where it applies). Any tile
b that is a multiple of 8 codes (the 3-bit packing takes groups of 8).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core import quantize as qz
from . import compaction as cp

B_DEFAULT = 256  # blocks per tile (128-byte max packed row)
CAPE = 128  # default per-chunk exception capacity (fallback: chunk width)
EXC_BITS = 8  # width-selection penalty per exception byte
_WIDTHS = (0, 1, 2, 3, 4)
_INF = 1 << 30


def tiles_of(nblk: int, b: int) -> int:
    return -(-nblk // b)


def packed_nbytes(widths, b: int):
    """Per-tile packed byte counts for host slicing/assembly (numpy)."""
    return (widths.astype(np.int64) * b) // 8


def _pack_w(vals: torch.Tensor, wb: int, b: int) -> torch.Tensor:
    """Pack (..., B) int32 nibbles (< 2^wb) into (..., B*wb//8) bytes."""
    if wb in (1, 2, 4):
        g = 8 // wb
        v = vals.reshape(*vals.shape[:-1], b // g, g)
        shifts = torch.arange(g, dtype=torch.int32, device=vals.device) * wb
        return torch.sum(v << shifts, dim=-1).to(torch.uint8)
    assert wb == 3
    v = vals.reshape(*vals.shape[:-1], b // 8, 8)
    shifts = torch.arange(8, dtype=torch.int32, device=vals.device) * 3
    w24 = torch.sum(v << shifts, dim=-1)  # 24 bits, little-endian groups
    by = torch.stack([w24 & 255, (w24 >> 8) & 255, (w24 >> 16) & 255], dim=-1)
    return by.reshape(*vals.shape[:-1], 3 * b // 8).to(torch.uint8)


def _unpack_w(rows: torch.Tensor, wb: int, b: int) -> torch.Tensor:
    """Inverse of _pack_w reading the (..., >=B*wb//8) byte-row prefix."""
    if wb in (1, 2, 4):
        g = 8 // wb
        by = rows[..., : b // g].to(torch.int32)
        shifts = torch.arange(g, dtype=torch.int32, device=rows.device) * wb
        v = (by[..., None] >> shifts) & ((1 << wb) - 1)
        return v.reshape(*rows.shape[:-1], b)
    by = rows[..., : 3 * b // 8].to(torch.int32).reshape(*rows.shape[:-1], b // 8, 3)
    w24 = by[..., 0] | (by[..., 1] << 8) | (by[..., 2] << 16)
    shifts = torch.arange(8, dtype=torch.int32, device=rows.device) * 3
    v = (w24[..., None] >> shifts) & 7
    return v.reshape(*rows.shape[:-1], b)


def _thr_block_major(width: torch.Tensor, nblk: int, b: int) -> torch.Tensor:
    """Per-tile markers 2^w - 1 (none for w = 0) on the (nblk, bs) grid."""
    t, bs = width.shape
    w32 = width.to(torch.int32)
    thr = torch.where(w32 > 0, (1 << w32) - 1, torch.full_like(w32, _INF))
    return thr[:, None, :].expand(t, b, bs).reshape(t * b, bs)[:nblk]


def _code_tiles(ids2d: torch.Tensor, n_valid: int, b: int):
    """Widths and packing of the (nblk, bs) grid at tile b: (width (T, bs)
    int32, packed (T*bs, b//2) u8, ids_i (nblk, bs) int32 with DC and
    padding zeroed, exc_mask (nblk, bs) bool: nibble >= the tile's marker)."""
    nblk, bs = ids2d.shape
    t = tiles_of(nblk, b)
    dev = ids2d.device
    pos = torch.arange(nblk * bs, device=dev).reshape(nblk, bs)
    valid = (pos < n_valid) & (pos % bs >= 1)
    ids_i = torch.where(valid, ids2d.to(torch.int32), 0).to(torch.int32)
    nib_bm = torch.clamp_max(ids_i, 15)

    pad = t * b - nblk
    nib_p = torch.nn.functional.pad(nib_bm, (0, 0, 0, pad)) if pad else nib_bm
    tiles = nib_p.reshape(t, b, bs).transpose(1, 2)  # (T, bs, B)

    maxv = tiles.amax(dim=-1)
    costs = [torch.where(maxv == 0, 0, _INF)]
    for wb in _WIDTHS[1:]:
        cnt = (tiles >= (1 << wb) - 1).sum(dim=-1, dtype=torch.int32)
        costs.append(wb * b + EXC_BITS * cnt)
    width = torch.argmin(torch.stack(costs), dim=0).to(torch.int32)  # first min

    cap = b // 2
    packed = torch.zeros((t, bs, cap), dtype=torch.uint8, device=dev)
    for wb in _WIDTHS[1:]:
        pk = _pack_w(torch.clamp_max(tiles, (1 << wb) - 1), wb, b)
        pk = torch.nn.functional.pad(pk, (0, cap - pk.shape[-1]))
        packed = torch.where((width == wb)[..., None], pk, packed)

    exc_mask = nib_bm >= _thr_block_major(width, nblk, b)
    return width, packed.reshape(t * bs, cap), ids_i, exc_mask


def _pack_ids(ids2d, n_valid: int, b: int, cape: int, compact):
    nblk, bs = ids2d.shape
    width, packed, ids_i, exc_mask = _code_tiles(ids2d, n_valid, b)
    cw = qz.chunk_width(nblk * bs, bs)
    cape = min(cape, cw)
    rows, counts = compact(exc_mask.reshape(-1, cw),
                           ids_i.reshape(-1, cw).to(torch.float32), cape)
    return (width.to(torch.uint8), packed, rows.to(torch.uint8), counts,
            torch.any(counts > cape))


def _compact_gated(mask2, vals2, capc):
    return cp.compact_chunked(mask2.reshape(-1), vals2.reshape(-1),
                              mask2.shape[1], capc)[:2]


def pack_ids(ids2d: torch.Tensor, n_valid: int, b: int, cape: int):
    """Code the (nblk, bs) bin-id grid (dctz_tpu's idpack.pack_ids): widths
    and packing in torch ops, the exception bytes compacted per block-major
    chunk row by compaction.compact_chunked (kernel H for CUDA tensors at
    the chunk widths it takes).

    Returns (width (T, bs) u8, packed (T*bs, b//2) u8, exc_rows (nc,
    min(cape, cw)) u8, exc_counts (nc,) i32, overflow bool tensor)."""
    return _pack_ids(ids2d, n_valid, b, cape, _compact_gated)


def _pack_ids_plain(ids2d: torch.Tensor, n_valid: int, b: int, cape: int):
    """pack_ids in torch ops alone, on any device."""
    return _pack_ids(ids2d, n_valid, b, cape, cp.compact_rows)


def _pack_ids_with_ac(ids2d, dcac2d, n_valid: int, b: int, cape: int, compact,
                      cw: int | None = None):
    nblk, bs = ids2d.shape
    cw = cw or qz.chunk_width(nblk * bs, bs)
    cape = min(cape, cw)
    width, packed, ids_i, exc_mask = _code_tiles(ids2d, n_valid, b)
    mask2 = exc_mask.reshape(-1, cw)
    ids2 = ids_i.reshape(-1, cw)
    exc_rows, ac_rows = compact(mask2, ids2.to(torch.uint8),
                                dcac2d.reshape(-1, cw).to(torch.float32), cape)
    exc_counts = mask2.sum(dim=1, dtype=torch.int32)
    ac_counts = (mask2 & (ids2 == C.ESCAPE)).sum(dim=1, dtype=torch.int32)
    return (width.to(torch.uint8), packed, exc_rows, exc_counts, ac_rows,
            ac_counts, dcac2d[:, 0].to(torch.float32).contiguous(),
            torch.any(exc_counts > cape))


def _pack_ids_with_ac_plain(ids2d: torch.Tensor, dcac2d: torch.Tensor,
                            n_valid: int, b: int, cape: int,
                            cw: int | None = None):
    """pack_ids_with_ac in torch ops alone, on any device (kernel B's
    twin): the exception bytes, and the AC values among the first `cape`
    exceptions (the sort arm of dctz_tpu's pack_ids_with_ac). cw: the chunk
    width, that of the length (qz.chunk_width) unless given."""
    from . import shuffle

    return _pack_ids_with_ac(
        ids2d, dcac2d, n_valid, b, cape,
        lambda m, i, v, c: shuffle._compact_unified_plain(m, i, v, c, c, c), cw)


def pack_ids_with_ac(ids2d: torch.Tensor, dcac2d: torch.Tensor, n_valid: int,
                     b: int, cape: int):
    """Code the (nblk, bs) bin-id grid and compact its AC escapes.

    Returns (width (T,bs) u8, packed (T*bs, b//2) u8, exc_rows (nc,cape) u8,
    exc_counts (nc,) i32, ac_rows (nc,cape) f32, ac_counts (nc,) i32,
    dc (nblk,) f32, overflow bool tensor). AC values are compacted among the
    first `cape` exceptions of each chunk row; both counts are the true,
    unclipped ones.

    Dispatched as dctz_tpu's pack_ids_with_ac: for CUDA tensors at kernel
    B's geometry (dpk_fuse.encode_eligible) dpk_fuse.encode_fused (kernel
    B); for CUDA tensors at any other tile or block size whose chunk width
    kernel J takes (compaction.kernel_eligible: a multiple of 32, float32
    values), widths and packing in torch ops, then shuffle.compact_unified
    (kernel J, _pack_ids_with_ac_unified); for the other chunk widths, and
    for CPU tensors, the plain version (the JAX package's sort pair). The card's arms cut the AC values at the
    exception rank min(cw, cape rounded up to 128), as the JAX kernels do:
    the same bytes as the plain version wherever cape is a multiple of 128
    or at least cw."""
    from . import dpk_fuse

    nblk, bs = ids2d.shape
    cw = qz.chunk_width(nblk * bs, bs)
    if (not dpk_fuse._on_cuda(ids2d, dcac2d)
            or not cp.kernel_eligible(cw, dcac2d.dtype)):
        return _pack_ids_with_ac_plain(ids2d, dcac2d, n_valid, b, cape)
    if dpk_fuse.encode_eligible(b, bs, cw):
        return dpk_fuse.encode_fused(ids2d, dcac2d, n_valid, b, min(cape, cw), cw)
    return _pack_ids_with_ac_unified(ids2d, dcac2d, n_valid, b, cape)


def _pack_ids_with_ac_unified(ids2d: torch.Tensor, dcac2d: torch.Tensor,
                              n_valid: int, b: int, cape: int):
    """pack_ids_with_ac's arm for any tile: widths and packing in torch ops,
    then one shuffle.compact_unified (kernel J on the card) for both
    streams, as dctz_tpu's shuffle arm."""
    from . import shuffle

    return _pack_ids_with_ac(
        ids2d, dcac2d, n_valid, b, cape,
        lambda m, i, v, c: shuffle.compact_unified(m, i, v, c, c))


def ac_chunk_counts(ids2d: torch.Tensor, n_valid: int, cw: int) -> torch.Tensor:
    """Per-chunk AC escape counts of an id grid (dctz_tpu/ops/idpack.py:
    326-339): the ESCAPE ids at AC positions below n_valid in each chunk row
    of cw ids -> (nblk*bs/cw,) int32. A DPK container stores them, so its
    decode never rescans the id stream."""
    nblk, bs = ids2d.shape
    pos = torch.arange(nblk * bs, device=ids2d.device).reshape(nblk, bs)
    esc = (ids2d.to(torch.int32) == C.ESCAPE) & (pos % bs >= 1) & (pos < n_valid)
    return esc.reshape(-1, cw).sum(dim=1, dtype=torch.int32)


def unpack_ids(width: torch.Tensor, packed: torch.Tensor, exc_rows: torch.Tensor,
               nblk: int, bs: int, b: int, cw: int, plain: bool = False) -> torch.Tensor:
    """Inverse of the packing -> (nblk, bs) uint8 with DC marks restored.

    width (T, bs); packed (T*bs, b//2) capacity rows; exc_rows (nc, cape) in
    block-major chunk order, cw the encoder's chunk width. The exception
    bytes return through compaction.expand_chunked (kernel I on the card
    where it takes the chunk width), as dctz_tpu's unpack_ids takes the
    Pallas expansion; plain=True keeps them in torch ops (expand_rows), for
    the plain versions of kernels C and M."""
    t = width.shape[0]
    wcol = width.reshape(t * bs).to(torch.int32)
    nib = torch.zeros((t * bs, b), dtype=torch.int32, device=packed.device)
    for wb in _WIDTHS[1:]:
        nib = torch.where((wcol == wb)[:, None], _unpack_w(packed, wb, b), nib)
    thr = torch.where(wcol > 0, (1 << wcol) - 1, torch.full_like(wcol, -1))
    mask_tm = nib == thr[:, None]
    nib_bm = nib.reshape(t, bs, b).transpose(1, 2).reshape(t * b, bs)[:nblk]
    mask = mask_tm.reshape(t, bs, b).transpose(1, 2).reshape(t * b, bs)[:nblk]
    expand = cp.expand_rows if plain else cp.expand_chunked
    exc = expand(mask.reshape(-1, cw), exc_rows.to(torch.int32))
    ids = torch.where(mask, exc.reshape(nblk, bs), nib_bm)
    ids[:, 0] = C.ESCAPE
    return ids.to(torch.uint8)

