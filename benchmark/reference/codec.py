"""The codec's arithmetic in float64 NumPy, written from its definition:
the scaling factor, the orthonormal 64-point DCT-II of each block of x / sf,
the zigzag bins of width 2 * eb * brsf around 0, the escapes (EC: the
coefficient itself; QT: renormalized through the quantizer table), and the
decode of a device-packed (DPK) v2 container back to samples.

DPK layout (after container.py has split the sections): the id grid is cut
into tiles of tile_b blocks; per tile and coefficient position the ids,
clipped to 15, are packed LSB first at a width w of 0-4 bits (a row of
w * tile_b / 8 bytes, rows tile-major then position-major); a value equal
to 2**w - 1 marks an id held in the exception section. The meta section
holds n_stream (u64), tile_b (u16), cw (u16), two pad bytes (14 bytes), then the
exception and AC counts (u16) of each chunk of cw grid positions. The
exception bytes and the AC escape values follow the grid's block-major
order, chunk by chunk.
"""

from __future__ import annotations

import concurrent.futures
import math
import struct

import numpy as np

from . import container as ct
from .frozen import BLK_SZ, ESCAPE, NBINS, QT_FACTOR, SF_ADJ_AMT

_META = struct.calcsize("<QHH2x")


def dct_basis(n: int = BLK_SZ) -> np.ndarray:
    """Orthonormal DCT-II basis in float64: B[k, m] = w(k) cos(pi (2m+1) k
    / 2n); coefficients = B @ block, block = B.T @ coefficients."""
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    b = np.cos(np.pi * (2.0 * m + 1.0) * k / (2.0 * n)) * math.sqrt(2.0 / n)
    b[0] *= math.sqrt(0.5)
    return b


def scaling_factor(x: np.ndarray, sf_adj: int = SF_ADJ_AMT) -> float:
    """10 ** (ceil(log10(max |x|)) - sf_adj), 1 for an all-zero array."""
    amax = float(np.abs(x).max()) if x.size else 0.0
    if amax == 0.0:
        return 1.0
    return 10.0 ** (math.ceil(math.log10(amax)) - sf_adj)


def geometry(eb: float, brsf: float = 1.0, nbins: int = NBINS):
    """(bin width, rmin, rmax) in doubles."""
    half = nbins // 2
    rmax = (2 * half + 1) * eb * brsf
    return 2.0 * eb * brsf, -rmax, rmax


def centers(ids: np.ndarray, w: float) -> np.ndarray:
    """The zigzag bin center of each id: even ids at -(id/2) w, odd ids at
    (id//2 + 1) w."""
    k = ids.astype(np.int64) // 2
    return np.where(ids % 2 == 1, k + 1, -k).astype(np.float64) * w


def zigzag(coef: np.ndarray, w: float, rmin: float, nbins: int = NBINS) -> np.ndarray:
    """The zigzag id of each coefficient's bin (the caller masks escapes)."""
    half = nbins // 2
    lin = np.clip(np.floor((coef - rmin) / w), 0, nbins - 1).astype(np.int64)
    return np.where(lin <= half, 2 * (half - lin), 2 * (lin - half) - 1)


def forward(x: np.ndarray, sf: float, bs: int = BLK_SZ) -> np.ndarray:
    """Coefficients (nblk, bs) of x / sf, zero-padded to whole blocks."""
    nblk = -(-x.size // bs)
    xs = np.zeros(nblk * bs, np.float64)
    xs[:x.size] = x
    xs /= sf
    return xs.reshape(nblk, bs) @ dct_basis(bs).T


def inverse(coef: np.ndarray, sf: float) -> np.ndarray:
    """Flat samples of (nblk, bs) coefficients, times sf."""
    return (coef @ dct_basis(coef.shape[1])).reshape(-1) * sf


def _unpack_rows(packed: bytes, widths: np.ndarray, tile_b: int) -> np.ndarray:
    """(rows, tile_b) values of the packed rows, rows = widths.size."""
    rows = widths.size
    out = np.zeros((rows, tile_b), np.int64)
    nbytes = widths.astype(np.int64) * tile_b // 8
    starts = np.concatenate(([0], np.cumsum(nbytes)))
    if starts[-1] != len(packed):
        raise ValueError("packed section length does not match the widths")
    buf = np.frombuffer(packed, np.uint8)
    for w in (1, 2, 3, 4):
        sel = np.flatnonzero(widths == w)
        if not sel.size:
            continue
        nb = w * tile_b // 8
        idx = starts[sel][:, None] + np.arange(nb)[None, :]
        bits = np.unpackbits(buf[idx], axis=1, bitorder="little")
        bits = bits.reshape(sel.size, tile_b, w).astype(np.int64)
        out[sel] = (bits << np.arange(w)).sum(axis=2)
    return out


def _per_chunk(mask: np.ndarray, cw: int) -> np.ndarray:
    return mask.reshape(-1, cw).sum(axis=1)


def dpk_stored(c: ct.Container, pool=None):
    """The stored coefficients of a DPK container: (ids (nblk, bs) with the
    DC slots ESCAPE, escape values (nblk, bs) float64 (0 where none), dc
    (nblk,) float64, n_stream). pool: rans.decompress's."""
    if not c.has(ct.FLAG_DPK):
        raise ValueError("not a DPK container")
    if c.has(ct.FLAG_F64) or not c.has(ct.FLAG_TRUNCATE) or c.has(ct.FLAG_DCD):
        raise ValueError("only float32 DPK containers without the DC delta")
    bs = c.block_size
    meta = ct.side_section(c, c.sections[3])
    n_stream, tile_b, cw = struct.unpack_from("<QHH2x", meta, 0)
    nblk = -(-n_stream // bs)
    nch = nblk * bs // cw
    if nch * cw != nblk * bs or len(meta) != _META + 4 * nch:
        raise ValueError("meta section does not match the grid")
    exc_counts = np.frombuffer(meta, np.uint16, nch, _META).astype(np.int64)
    ac_counts = np.frombuffer(meta, np.uint16, nch, _META + 2 * nch).astype(np.int64)
    t = -(-nblk // tile_b)
    widths = np.frombuffer(ct.side_section(c, c.sections[0]), np.uint8)
    if widths.size != t * bs or widths.max(initial=0) > 4:
        raise ValueError("width section does not match the grid")
    vals = _unpack_rows(ct.packed_section(c, c.sections[1]), widths, tile_b)
    # rows (t, pos) of tile_b blocks -> the (block, pos) grid
    grid = vals.reshape(t, bs, tile_b).transpose(0, 2, 1).reshape(t * tile_b, bs)
    wgrid = np.repeat(widths.reshape(t, 1, bs), tile_b, axis=1).reshape(t * tile_b, bs)
    grid, wgrid = grid[:nblk], wgrid[:nblk]
    marker = np.where(wgrid > 0, (1 << wgrid.astype(np.int64)) - 1, -1)
    emask = grid == marker
    # the entropy-coded sections side by side (their rANS blobs on the pool)
    with concurrent.futures.ThreadPoolExecutor(3) as threads:
        f_exc = threads.submit(ct.exception_section, c, c.sections[2], pool)
        f_dc = threads.submit(ct.float_section, c, c.sections[4], pool)
        f_ac = threads.submit(ct.float_section, c, c.sections[5], pool)
        exc = np.frombuffer(f_exc.result(), np.uint8)
        dc_planes, ac_planes = f_dc.result(), f_ac.result()
    if exc.size != int(emask.sum()) or not np.array_equal(
            _per_chunk(emask.reshape(-1), cw), exc_counts):
        raise ValueError("exception section does not match the packed ids")
    ids = grid.copy()
    ids[emask] = exc
    ids[:, 0] = ESCAPE
    pos = np.arange(nblk * bs).reshape(nblk, bs)
    amask = (ids == ESCAPE) & (pos % bs != 0) & (pos < n_stream)
    if not np.array_equal(_per_chunk(amask.reshape(-1), cw), ac_counts):
        raise ValueError("AC counts do not match the escapes")
    dc = _floats(*dc_planes, nblk)
    ac = _floats(*ac_planes, int(amask.sum()))
    if ac.size != c.ac_count:
        raise ValueError("AC section length does not match the header")
    esc = np.zeros((nblk, bs), np.float64)
    esc[amask] = ac
    return ids, esc, dc, n_stream


def _floats(isz: int, planes: list, count: int) -> np.ndarray:
    if isz != 4:
        raise ValueError("float32 streams expected")
    a = np.stack([np.frombuffer(p, np.uint8) for p in planes])
    if a.shape[1] != count:
        raise ValueError("stream length does not match its count")
    u = (a[0].astype(np.uint32) | (a[1].astype(np.uint32) << 8)
         | (a[2].astype(np.uint32) << 16) | (a[3].astype(np.uint32) << 24))
    return u.view(np.float32).astype(np.float64)


def qtable_of(c: ct.Container) -> np.ndarray | None:
    if c.qtable is None:
        return None
    return np.frombuffer(c.qtable, np.float32).astype(np.float64)


def coefficients(c: ct.Container, ids, esc, dc) -> tuple[np.ndarray, np.ndarray]:
    """(coefficients (nblk, bs) float64, binned mask) from the stored ids,
    escape values and DC: bin centers, the escapes (QT: renormalization
    inverted), the DC column."""
    w, rmin, rmax = geometry(c.error_bound, c.brsf, c.nbins)
    coef = centers(ids, w)
    escm = ids == ESCAPE
    escm[:, 0] = False
    q = qtable_of(c)
    if q is not None:
        side = np.where(esc > 0, rmax, rmin)
        vals = ((esc - side) / (c.error_bound * QT_FACTOR)) * q[None, :]
    else:
        vals = esc
    coef = np.where(escm, vals, coef)
    coef[:, 0] = dc
    binned = ~escm
    binned[:, 0] = False
    return coef, binned


def decode(blob) -> np.ndarray:
    """Samples (float64) of one DPK container."""
    c = ct.parse(blob)
    ids, esc, dc, _ = dpk_stored(c)
    coef, _ = coefficients(c, ids, esc, dc)
    return inverse(coef, c.scaling_factor)[:c.n]
