"""Bin assignment and dequantization (port of dctz_tpu/core/quantize.py).

The bin geometry, the compaction chunk width, pass-1 bin assignment with
escapes, the QT quantizer table (qtable), the renormalization of escapes
through it and its inverse, the generic chain's quantization (quantize) and
chunked AC compaction (repack, kernel H on the card), the expansion of the
AC rows back onto the escapes (expand_ac, kernel I), and the dequantization
of bin ids plus escaped values back to coefficients.

All of it runs in float32, as the fused TPU path does and as dctz_tpu's
generic chain does with x64 off (its float32 input default): the float64
arm of dctz_tpu.core.quantize.encode/decode (promote=True under x64) is not
ported (ROADMAP item 9). Every QT step is a separate, individually rounded
float32 operation; the CUDA kernels reproduce that order with IEEE
intrinsics (csrc/common.cuh).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CodecConfig
from . import constants as C
from .binning import linear_to_zigzag, zigzag_to_center


def _geometry(cfg: CodecConfig) -> tuple[float, float, float]:
    """(w, rmin, rmax) computed in double and rounded once to float32, as
    the reference assigns them (dctz-comp-lib.c:271-281); returned as the
    Python floats of those float32 values."""
    eb = float(cfg.error_bound)
    half = cfg.nbins // 2
    w_d = eb * 2.0 * cfg.brsf
    rmax_d = (half * 2 + 1) * (eb * cfg.brsf)
    return (
        float(np.float32(w_d)),
        float(np.float32(-rmax_d)),
        float(np.float32(rmax_d)),
    )


def chunk_width(total: int, block_size: int) -> int:
    """Largest supported compaction chunk width dividing the padded size
    (always a block multiple, so no chunk splits a block)."""
    from ..ops.compaction import CHUNK_W

    k = max(CHUNK_W // block_size, 1)
    while k > 1 and total % (k * block_size) != 0:
        k //= 2
    return k * block_size


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def assign_bins(coeffs: torch.Tensor, cfg: CodecConfig):
    """Pass-1 bin assignment: (in_range, zigzag ids int32)."""
    w, rmin, rmax = _geometry(cfg)
    dev = coeffs.device
    in_range = (coeffs >= _f32(rmin, dev)) & (coeffs <= _f32(rmax, dev))
    q = (coeffs - _f32(rmin, dev)) / _f32(w, dev)
    lin = torch.clamp(q.to(torch.int32), 0, cfg.nbins - 1)
    return in_range, linear_to_zigzag(lin, cfg.nbins)


def ac_mask(nblk: int, bs: int, n: int, device) -> torch.Tensor:
    """Positions that map to a real element and are not the DC slot."""
    pos = torch.arange(nblk * bs, device=device).reshape(nblk, bs)
    return (pos < n) & (pos % bs >= 1)


def encode_ids(coeffs: torch.Tensor, n: int, cfg: CodecConfig) -> torch.Tensor:
    """EC bin ids (nblk, bs) int32: ESCAPE at the DC slots, at out-of-range
    AC coefficients and at positions >= n (the stored value of an escape is
    the coefficient itself)."""
    nblk, bs = coeffs.shape
    in_range, ids = assign_bins(coeffs, cfg)
    binned = ac_mask(nblk, bs, n, coeffs.device) & in_range
    return torch.where(binned, ids, torch.full_like(ids, C.ESCAPE))


def qt_renorm(coeffs: torch.Tensor, qtable: torch.Tensor,
              cfg: CodecConfig) -> torch.Tensor:
    """The stored value of a QT escape: ((c / q) * eb) * qt_factor + side,
    side = rmax for c > 0 else rmin (chosen by sign, as
    dctz_tpu/ops/dpk_fuse.py:536-538 does; for a coefficient out of range
    that is its own side). qtable (bs,) broadcasts over the rows."""
    _, rmin, rmax = _geometry(cfg)
    dev = coeffs.device
    side = torch.where(coeffs > 0, _f32(rmax, dev), _f32(rmin, dev))
    q = qtable.to(torch.float32)[None, :]
    return ((coeffs / q) * _f32(cfg.error_bound, dev)) * _f32(
        cfg.qt_factor, dev
    ) + side


def qt_denom(cfg: CodecConfig) -> float:
    """The inverse's divisor f32(eb) * f32(qt_factor), one float32 product
    (dctz_tpu/ops/dpk_fuse.py:993), as a Python float."""
    return float(np.float32(cfg.error_bound) * np.float32(cfg.qt_factor))


def qt_inverse(vals: torch.Tensor, qtable: torch.Tensor,
               cfg: CodecConfig) -> torch.Tensor:
    """Inverse of qt_renorm: ((v - side) / qt_denom(cfg)) * q, side taken
    from the sign of the stored value (dctz_tpu/ops/dpk_fuse.py:212-218)."""
    _, rmin, rmax = _geometry(cfg)
    dev = vals.device
    side = torch.where(vals > 0, _f32(rmax, dev), _f32(rmin, dev))
    return ((vals - side) / _f32(qt_denom(cfg), dev)) * qtable.to(
        torch.float32)[None, :]


def encode_ids_qt(coeffs: torch.Tensor, n: int, cfg: CodecConfig,
                  qtable: torch.Tensor):
    """QT bin ids (nblk, bs) int32: an out-of-range AC coefficient is
    renormalized through the qtable and re-binned if it lands in range
    (dctz_tpu/ops/dpk_fuse.py:534-542); ESCAPE at the DC slots, at what
    stays out of range and at positions >= n. The stored value of an escape
    is its renormalized value (ops/repair.stored_dense)."""
    nblk, bs = coeffs.shape
    in_range, _ = assign_bins(coeffs, cfg)
    norm = qt_renorm(coeffs, qtable, cfg)
    re_in, ids = assign_bins(torch.where(in_range, coeffs, norm), cfg)
    binned = ac_mask(nblk, bs, n, coeffs.device) & re_in
    return torch.where(binned, ids, torch.full_like(ids, C.ESCAPE))


class Quantized(NamedTuple):
    """One array's quantized streams in the chunked AC layout (the JAX
    package's chunked Quantized): ac_buf (nc, capc) rows, ac_count (nc,)
    their true counts. overflowed: whether the default capacity overflowed
    (repack then recompacted at full chunk width, so nothing was lost)."""

    bin_ids: torch.Tensor  # (nblk, bs) uint8; DC, escapes, padding: ESCAPE
    dc: torch.Tensor  # (nblk,) float32
    ac_buf: torch.Tensor  # (nc, capc) float32
    ac_count: torch.Tensor  # (nc,) int32
    qtable: torch.Tensor | None  # (bs,) QT only
    overflowed: torch.Tensor  # bool scalar


def escape_colmax(coeffs: torch.Tensor, n: int, cfg: CodecConfig):
    """QT pass 1: the per-position max |escaped AC coefficient| over the
    real positions, unclamped; slot 0 is 0 (the DC slot is never an AC
    escape). The DTZS writer max-reduces these over its segments
    (dctz_tpu/stream.py:_qtable_colmax_segment)."""
    nblk, bs = coeffs.shape
    in_range, _ = assign_bins(coeffs, cfg)
    escape = ac_mask(nblk, bs, n, coeffs.device) & ~in_range
    return torch.where(escape, torch.abs(coeffs),
                       torch.zeros_like(coeffs)).amax(dim=0)


def qtable_colmax(coeffs: torch.Tensor, n: int, cfg: CodecConfig,
                  ext_qtable: torch.Tensor | None = None):
    """The generic chain's qtable (dctz_tpu/core/quantize.py:186-205): the
    column max (this array's escape_colmax, or ext_qtable, the writer's
    global one) clamped to >= 1.0, with slot 0 = the DC of the last block,
    unclamped (the reference quirk; the decoder never reads it)."""
    col_max = escape_colmax(coeffs, n, cfg) if ext_qtable is None else ext_qtable
    qtable = torch.clamp_min(col_max.to(torch.float32), 1.0)
    qtable[0] = coeffs[-1, 0]
    return qtable


def quantize(coeffs: torch.Tensor, n: int, cfg: CodecConfig,
             ext_qtable: torch.Tensor | None = None):
    """Pass 1 and pass 2 of the generic chain on padded block coefficients
    (nblk, bs), n the true element count: (bin ids int32 (nblk, bs), dc
    (nblk,), stored values (nblk, bs), qtable or None). The stored value of
    an escape is the coefficient (EC) or its renormalization (QT) through
    the qtable of these coefficients or, given ext_qtable (the DTZS
    writer's global column max), through that one (qtable_colmax).
    dctz_tpu's quantize.encode is this followed by the compaction (repack
    here); the caller verifies in between when asked to."""
    dc = coeffs[:, 0]
    if cfg.mode != "qt":
        return encode_ids(coeffs, n, cfg), dc, coeffs, None
    qtable = qtable_colmax(coeffs, n, cfg, ext_qtable)
    in_range, _ = assign_bins(coeffs, cfg)
    vals = torch.where(in_range, coeffs, qt_renorm(coeffs, qtable, cfg))
    return encode_ids_qt(coeffs, n, cfg, qtable), dc, vals, qtable


def repack(bin_ids: torch.Tensor, dense_vals: torch.Tensor, dc: torch.Tensor,
           qtable: torch.Tensor | None, n: int, cfg: CodecConfig) -> Quantized:
    """Compact the stored values at the AC escapes of the first n positions
    into chunk rows of the default capacity, and again at full chunk width
    when a row overflows (kernel H for CUDA tensors; only the compaction is
    rerun). The streams are those of dctz_tpu's _compact_stream / repack and
    its overflow retry."""
    from ..ops import compaction as cp

    nblk, bs = bin_ids.shape
    escape = ac_mask(nblk, bs, n, bin_ids.device) & (bin_ids == C.ESCAPE)
    cw = chunk_width(nblk * bs, bs)
    flat_m, flat_v = escape.reshape(-1), dense_vals.reshape(-1)
    ac, counts, ovf = cp.compact_chunked(flat_m, flat_v, cw, min(cp.CAPC, cw))
    if bool(ovf):
        ac, counts, _ = cp.compact_chunked(flat_m, flat_v, cw, cw)
    return Quantized(bin_ids.to(torch.uint8), dc, ac, counts, qtable, ovf)


def expand_ac(bin_ids: torch.Tensor, ac_rows: torch.Tensor, n: int):
    """The chunked-layout half of dctz_tpu's quantize.decode: the AC rows
    back at the escapes of the first n positions (kernel I for CUDA
    tensors) -> (nblk, bs) float32, 0 elsewhere. decode_dense (kernel D on
    the card) dequantizes the rest."""
    from ..ops import compaction as cp

    nblk, bs = bin_ids.shape
    escape = ac_mask(nblk, bs, n, bin_ids.device) & (bin_ids == C.ESCAPE)
    return cp.expand_chunked(escape.reshape(ac_rows.shape[0], -1),
                             ac_rows).reshape(nblk, bs)


def decode_dense(
    ids: torch.Tensor, dc: torch.Tensor, ac_vals: torch.Tensor, n: int,
    cfg: CodecConfig, qtable: torch.Tensor | None = None,
) -> torch.Tensor:
    """Coefficients (nblk, bs) from bin ids, the per-block DC and the
    escaped values held in place (ac_vals (nblk, bs)): escapes read ac_vals
    (through qt_inverse when a qtable is given), everything else its zigzag
    bin center, column 0 the DC."""
    nblk, bs = ids.shape
    w, _, _ = _geometry(cfg)
    ids = ids.to(torch.int32)
    escape = ac_mask(nblk, bs, n, ids.device) & (ids == C.ESCAPE)
    ac_vals = ac_vals.to(torch.float32)
    if qtable is not None:
        ac_vals = qt_inverse(ac_vals, qtable, cfg)
    coeffs = torch.where(escape, ac_vals, zigzag_to_center(ids, w))
    coeffs[:, 0] = dc.to(torch.float32)
    return coeffs
