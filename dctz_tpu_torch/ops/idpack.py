"""Device coding of the bin-id stream, "DPK" (port of dctz_tpu/ops/idpack.py).

Per tile of B = 256 blocks and per coefficient position, the nibbles
min(id, 15) pack at the width w in 0..4 that minimises w*B + 8*#exceptions
(first minimum wins); nibbles >= 2^w - 1 pack as that marker and their
original id byte goes to the exception stream, compacted in block-major
chunk rows like the AC stream. These are the plain versions: pack_ids_with_ac
is kernel B's twin and unpack_ids is the id half of kernel C's twin
(ops/dpk_fuse.py).
"""

from __future__ import annotations

import torch

from ..core import constants as C
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
    import numpy as np

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


def pack_ids_with_ac(ids2d: torch.Tensor, dcac2d: torch.Tensor, n_valid: int,
                     b: int, cape: int):
    """Code the (nblk, bs) bin-id grid and compact its AC escapes.

    Returns (width (T,bs) u8, packed (T*bs, b//2) u8, exc_rows (nc,cape) u8,
    exc_counts (nc,) i32, ac_rows (nc,cape) f32, ac_counts (nc,) i32,
    dc (nblk,) f32, overflow bool tensor). AC values are compacted among the
    first `cape` exceptions of each chunk row; both counts are the true,
    unclipped ones."""
    from ..core.quantize import chunk_width

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
    cw = chunk_width(nblk * bs, bs)
    cape = min(cape, cw)
    mask2 = exc_mask.reshape(-1, cw)
    ids2 = ids_i.reshape(-1, cw)
    vals2 = dcac2d.reshape(-1, cw).to(torch.float32)
    exc_rows, exc_counts = cp.compact_rows(mask2, ids2, cape)
    rank = torch.cumsum(mask2.to(torch.int32), dim=1) - 1
    esc = mask2 & (ids2 == C.ESCAPE)
    ac_rows, _ = cp.compact_rows(esc & (rank < cape), vals2, cape)
    ac_counts = esc.sum(dim=1, dtype=torch.int32)
    return (
        width.to(torch.uint8),
        packed.reshape(t * bs, cap),
        exc_rows.to(torch.uint8),
        exc_counts,
        ac_rows,
        ac_counts,
        dcac2d[:, 0].to(torch.float32).contiguous(),
        torch.any(exc_counts > cape),
    )


def unpack_ids(width: torch.Tensor, packed: torch.Tensor, exc_rows: torch.Tensor,
               nblk: int, bs: int, b: int, cw: int) -> torch.Tensor:
    """Inverse of the packing -> (nblk, bs) uint8 with DC marks restored.

    width (T, bs); packed (T*bs, b//2) capacity rows; exc_rows (nc, cape) in
    block-major chunk order, cw the encoder's chunk width."""
    t = width.shape[0]
    wcol = width.reshape(t * bs).to(torch.int32)
    nib = torch.zeros((t * bs, b), dtype=torch.int32, device=packed.device)
    for wb in _WIDTHS[1:]:
        nib = torch.where((wcol == wb)[:, None], _unpack_w(packed, wb, b), nib)
    thr = torch.where(wcol > 0, (1 << wcol) - 1, torch.full_like(wcol, -1))
    mask_tm = nib == thr[:, None]
    nib_bm = nib.reshape(t, bs, b).transpose(1, 2).reshape(t * b, bs)[:nblk]
    mask = mask_tm.reshape(t, bs, b).transpose(1, 2).reshape(t * b, bs)[:nblk]
    exc = cp.expand_rows(mask.reshape(-1, cw), exc_rows.to(torch.int32))
    ids = torch.where(mask, exc.reshape(nblk, bs), nib_bm)
    ids[:, 0] = C.ESCAPE
    return ids.to(torch.uint8)
