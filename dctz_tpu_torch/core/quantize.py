"""Bin assignment and dequantization (port of dctz_tpu/core/quantize.py).

The bin geometry, the compaction chunk width, pass-1 bin assignment with
escapes, the QT quantizer table (qtable), the renormalization of escapes
through it and its inverse, the generic chain's quantization (quantize) and
chunked AC compaction (repack, kernel H on the card), the expansion of the
AC rows back onto the escapes (expand_ac, kernel I), and the dequantization
of bin ids plus escaped values back to coefficients.

Every step runs in the coefficients' dtype. Float32 is the fused TPU
path's arithmetic and dctz_tpu's generic chain with x64 off: every QT step
is a separate, individually rounded float32 operation, and the CUDA kernels
reproduce that order with IEEE intrinsics (csrc/common.cuh). Float64 is
dctz_tpu's generic chain with x64 on, the arithmetic of the C codec's
double build: the geometry, the bins, the QT renormalization and its
inverse in doubles. The stored DC and escape values are float32 either way
with truncate on (USE_TRUNCATE in dctz-comp-lib.c:102-105): repack rounds
them; with truncate off they keep the data's dtype (stored_dtype).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CodecConfig
from . import constants as C
from .binning import linear_to_zigzag, zigzag_to_center


def _geometry(cfg: CodecConfig,
              dtype: torch.dtype = torch.float32) -> tuple[float, float, float]:
    """(w, rmin, rmax) computed in double and rounded once to `dtype`, as
    the reference assigns them (dctz-comp-lib.c:271-281); returned as the
    Python floats of those values (for float64 the doubles themselves)."""
    eb = float(cfg.error_bound)
    half = cfg.nbins // 2
    w_d = eb * 2.0 * cfg.brsf
    rmax_d = (half * 2 + 1) * (eb * cfg.brsf)
    if dtype == torch.float64:
        return w_d, -rmax_d, rmax_d
    return (
        float(np.float32(w_d)),
        float(np.float32(-rmax_d)),
        float(np.float32(rmax_d)),
    )


def stored_dtype(cfg: CodecConfig, dtype: torch.dtype) -> torch.dtype:
    """The dtype of the stored DC and escape values: float32 with truncate
    on (USE_TRUNCATE, dctz-comp-lib.c:102-105), the data's own with it off
    (full-width streams: 8-byte items for float64 data)."""
    return torch.float32 if cfg.truncate else dtype


def chunk_width(total: int, block_size: int) -> int:
    """Largest supported compaction chunk width dividing the padded size
    (always a block multiple, so no chunk splits a block)."""
    from ..ops.compaction import CHUNK_W

    k = max(CHUNK_W // block_size, 1)
    while k > 1 and total % (k * block_size) != 0:
        k //= 2
    return k * block_size


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """The scalar v as a tensor of like's dtype on like's device."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def assign_bins(coeffs: torch.Tensor, cfg: CodecConfig):
    """Pass-1 bin assignment in the coefficients' dtype: (in_range, zigzag
    ids int32)."""
    w, rmin, rmax = _geometry(cfg, coeffs.dtype)
    in_range = (coeffs >= _c(rmin, coeffs)) & (coeffs <= _c(rmax, coeffs))
    q = (coeffs - _c(rmin, coeffs)) / _c(w, coeffs)
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
    that is its own side), in the coefficients' dtype (for float64 the
    doubles of dctz_tpu/core/quantize.py:164-170). qtable (bs,) broadcasts
    over the rows."""
    _, rmin, rmax = _geometry(cfg, coeffs.dtype)
    side = torch.where(coeffs > 0, _c(rmax, coeffs), _c(rmin, coeffs))
    q = qtable.to(coeffs.dtype)[None, :]
    return ((coeffs / q) * _c(cfg.error_bound, coeffs)) * _c(
        cfg.qt_factor, coeffs
    ) + side


def qt_denom(cfg: CodecConfig, dtype: torch.dtype = torch.float32) -> float:
    """The inverse's divisor eb * qt_factor, one product in `dtype`: of the
    float32 roundings for float32 (dctz_tpu/ops/dpk_fuse.py:993), of the
    doubles for float64 (dctz_tpu/core/quantize.py:331-333), as a Python
    float."""
    if dtype == torch.float64:
        return float(cfg.error_bound) * float(cfg.qt_factor)
    return float(np.float32(cfg.error_bound) * np.float32(cfg.qt_factor))


def qt_inverse(vals: torch.Tensor, qtable: torch.Tensor,
               cfg: CodecConfig) -> torch.Tensor:
    """Inverse of qt_renorm in the dtype of vals: ((v - side) /
    qt_denom(cfg)) * q, side taken from the sign of the stored value
    (dctz_tpu/ops/dpk_fuse.py:212-218)."""
    _, rmin, rmax = _geometry(cfg, vals.dtype)
    side = torch.where(vals > 0, _c(rmax, vals), _c(rmin, vals))
    return ((vals - side) / _c(qt_denom(cfg, vals.dtype), vals)) * qtable.to(
        vals.dtype)[None, :]


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
    dc: torch.Tensor  # (nblk,) float32 (truncate off: the data's dtype)
    ac_buf: torch.Tensor  # (nc, capc) float32 (truncate off: data dtype)
    ac_count: torch.Tensor  # (nc,) int32
    qtable: torch.Tensor | None  # (bs,) QT only, the coefficients' dtype
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
    qtable = torch.clamp_min(col_max.to(coeffs.dtype), 1.0)
    qtable[0] = coeffs[-1, 0]
    return qtable


def quantize(coeffs: torch.Tensor, n: int, cfg: CodecConfig,
             ext_qtable: torch.Tensor | None = None):
    """Pass 1 and pass 2 of the generic chain on padded block coefficients
    (nblk, bs), n the true element count: (bin ids int32 (nblk, bs), dc
    (nblk,) of stored_dtype, stored values (nblk, bs) in the coefficients'
    dtype, rounded to stored_dtype by repack, qtable or None). The stored
    value of an escape is the coefficient (EC) or its renormalization (QT) through
    the qtable of these coefficients or, given ext_qtable (the DTZS
    writer's global column max), through that one (qtable_colmax).
    dctz_tpu's quantize.encode is this followed by the compaction (repack
    here); the caller verifies in between when asked to."""
    dc = coeffs[:, 0].to(stored_dtype(cfg, coeffs.dtype))
    if cfg.mode != "qt":
        return encode_ids(coeffs, n, cfg), dc, coeffs, None
    qtable = qtable_colmax(coeffs, n, cfg, ext_qtable)
    in_range, _ = assign_bins(coeffs, cfg)
    vals = torch.where(in_range, coeffs, qt_renorm(coeffs, qtable, cfg))
    return encode_ids_qt(coeffs, n, cfg, qtable), dc, vals, qtable


def repack(bin_ids: torch.Tensor, dense_vals: torch.Tensor, dc: torch.Tensor,
           qtable: torch.Tensor | None, n: int, cfg: CodecConfig) -> Quantized:
    """Compact the stored values at the AC escapes of the first n positions,
    rounded to stored_dtype (float32 with truncate on), into chunk rows of
    the default capacity, and again at full chunk width when a row
    overflows (compaction.compact_chunked: kernel H for CUDA tensors where
    it applies; only the compaction is rerun). The streams are those of
    dctz_tpu's _compact_stream / repack and its overflow retry."""
    from ..ops import compaction as cp

    nblk, bs = bin_ids.shape
    escape = ac_mask(nblk, bs, n, bin_ids.device) & (bin_ids == C.ESCAPE)
    cw = chunk_width(nblk * bs, bs)
    flat_m = escape.reshape(-1)
    flat_v = dense_vals.reshape(-1).to(stored_dtype(cfg, dense_vals.dtype))
    ac, counts, ovf = cp.compact_chunked(flat_m, flat_v, cw, min(cp.CAPC, cw))
    if bool(ovf):
        ac, counts, _ = cp.compact_chunked(flat_m, flat_v, cw, cw)
    return Quantized(bin_ids.to(torch.uint8), dc, ac, counts, qtable, ovf)


def expand_ac(bin_ids: torch.Tensor, ac_rows: torch.Tensor, n: int):
    """The chunked-layout half of dctz_tpu's quantize.decode: the AC rows
    back at the escapes of the first n positions (compaction.expand_chunked:
    kernel I for CUDA tensors where it applies) -> (nblk, bs) of the rows'
    dtype, 0 elsewhere. decode_dense (kernel D on the card) dequantizes the
    rest."""
    from ..ops import compaction as cp

    nblk, bs = bin_ids.shape
    escape = ac_mask(nblk, bs, n, bin_ids.device) & (bin_ids == C.ESCAPE)
    return cp.expand_chunked(escape.reshape(ac_rows.shape[0], -1),
                             ac_rows).reshape(nblk, bs)


def decode_dense(
    ids: torch.Tensor, dc: torch.Tensor, ac_vals: torch.Tensor, n: int,
    cfg: CodecConfig, qtable: torch.Tensor | None = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Coefficients (nblk, bs) in `dtype` from bin ids, the per-block DC
    and the escaped values held in place (ac_vals (nblk, bs)): escapes read
    ac_vals (through qt_inverse when a qtable is given), everything else its
    zigzag bin center, column 0 the DC. float64 is dctz_tpu's decode with
    x64 on (dctz_tpu/core/quantize.py:298-360): the stored float32 values
    widened, the geometry and the QT inverse in doubles."""
    nblk, bs = ids.shape
    w, _, _ = _geometry(cfg, dtype)
    ids = ids.to(torch.int32)
    escape = ac_mask(nblk, bs, n, ids.device) & (ids == C.ESCAPE)
    ac_vals = ac_vals.to(dtype)
    if qtable is not None:
        ac_vals = qt_inverse(ac_vals, qtable, cfg)
    coeffs = torch.where(escape, ac_vals, zigzag_to_center(ids, w, dtype))
    coeffs[:, 0] = dc.to(dtype)
    return coeffs


def decode_x(ids, dc, ac_vals, n: int, cfg: CodecConfig, sf: torch.Tensor,
             qtable=None, dtype: torch.dtype = torch.float32):
    """dctz_tpu/api.py:_decode_core on in-place stored values: decode_dense
    over the first n positions, the inverse transform (a rem-point basis for
    a partial last block) and the unscaling, all in `dtype`. Returns
    (coefficients (nblk, bs), samples (n,))."""
    from . import transform

    coeffs = decode_dense(ids, dc, ac_vals, n, cfg, qtable, dtype)
    n_full, rem = divmod(n, cfg.block_size)
    tail = coeffs[n_full, :rem] if rem else coeffs.new_zeros((0,))
    x = transform.inverse(coeffs[:n_full], tail)
    return coeffs, (x * sf.to(dtype))[:n]
