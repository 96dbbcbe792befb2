"""EC bin assignment and dequantization (port of dctz_tpu/core/quantize.py).

Only what the DPK EC slice needs: the bin geometry, the compaction chunk
width, pass-1 bin assignment with escapes, and the dequantization of bin
ids plus escaped values back to coefficients. QT mode waits for ROADMAP
item 7.
"""

from __future__ import annotations

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


def decode_dense(
    ids: torch.Tensor, dc: torch.Tensor, ac_vals: torch.Tensor, n: int,
    cfg: CodecConfig,
) -> torch.Tensor:
    """Coefficients (nblk, bs) from bin ids, the per-block DC and the
    escaped values held in place (ac_vals (nblk, bs)): escapes read ac_vals,
    everything else its zigzag bin center, column 0 the DC."""
    nblk, bs = ids.shape
    w, _, _ = _geometry(cfg)
    ids = ids.to(torch.int32)
    escape = ac_mask(nblk, bs, n, ids.device) & (ids == C.ESCAPE)
    coeffs = torch.where(escape, ac_vals.to(torch.float32), zigzag_to_center(ids, w))
    coeffs[:, 0] = dc.to(torch.float32)
    return coeffs
