"""Encode-side verify-and-repair (port of dctz_tpu/ops/repair.py).

Reconstruct the array exactly as the decoder will, find blocks whose
pointwise error exceeds the tolerance, and force their error-carrying
coefficients to ESCAPE in two passes with falling floors (w/8, then
w*1e-3); `ok` reports whether every block then holds. EC stores an escape
as the coefficient itself; QT stores it renormalized through the qtable
(quantize.qt_renorm, side chosen by sign), and the reconstruction inverts
that exactly as the decoder does. A QT escape carries about 1.5e-6 *
qtable[j] of error, so QT never forces a coefficient whose bin error is
below 3e-6 * |qtable[j]|. This is the plain version of the verify half of
kernel A (ops/dpk_fuse.dct_quant_verify).

Everything runs in the coefficients' dtype. For float64 data that is
dctz_tpu's verify-repair with x64 on: the geometry, floors and tolerance in
doubles, and a float64 reconstruction from the float32 stored values.
"""

from __future__ import annotations

import torch

from ..config import CodecConfig
from ..core import constants as C
from ..core import quantize as qz

_SLACK = 0.99  # verify against 0.99*tol: absorbs cross-backend ulp drift


def stored_dense(coeffs, ids, acm, cfg: CodecConfig, qtable):
    """Per-position stored values as the container carries them: EC stores
    the coefficient, QT the renormalized value at AC escapes
    (dctz_tpu/ops/repair.py:52-67)."""
    if qtable is None:
        return coeffs
    escape = acm & (ids == C.ESCAPE)
    return torch.where(escape, qz.qt_renorm(coeffs, qtable, cfg), coeffs)


def verify_repair(x, coeffs, sf, bin_ids, dc, n_decode: int, n_valid: int,
                  cfg: CodecConfig, tol: torch.Tensor,
                  qtable: torch.Tensor | None = None):
    """x: the input as the encoder saw it (length n_decode; positions >=
    n_valid are padding); coeffs: scaled-domain coefficients (nblk, bs);
    tol: the pre-slacked absolute tolerance (a tensor of the coefficients'
    dtype); qtable: the (bs,) quantizer table in QT mode, None in EC mode.
    The stored values are rounded to their stored dtype (float32 with
    truncate on) before the reconstruction, as the container carries them.
    Returns (bin ids int32, ok bool tensor)."""
    if (qtable is None) != (cfg.mode == "ec"):
        raise ValueError(f"mode {cfg.mode!r} with qtable={qtable is not None}")
    nblk, bs = coeffs.shape
    dev, dtype = coeffs.device, coeffs.dtype
    w, _, _ = qz._geometry(cfg, dtype)
    acm = qz.ac_mask(nblk, bs, n_decode, dev)
    valid = torch.arange(nblk * bs, device=dev).reshape(nblk, bs) < n_valid
    qt_floor = (
        qz._c(3e-6, coeffs) * torch.abs(qtable.to(dtype))[None, :]
        if qtable is not None
        else torch.zeros((1, bs), dtype=dtype, device=dev)
    )

    def block_errors(ids):
        dense = stored_dense(coeffs, ids, acm, cfg, qtable).to(
            qz.stored_dtype(cfg, dtype))
        coeffs_hat, xhat = qz.decode_x(ids, dc, dense, n_decode, cfg, sf,
                                       qtable, dtype)
        err = torch.zeros(nblk * bs, dtype=dtype, device=x.device)
        err[:n_decode] = torch.abs(xhat - x[:n_decode])
        err = torch.where(valid, err.reshape(nblk, bs), torch.zeros_like(coeffs))
        return err.amax(dim=1), torch.abs(coeffs - coeffs_hat)

    ids = bin_ids.to(torch.int32)
    wt = torch.tensor(w, dtype=dtype)
    for pass_floor in (wt / 8, wt * torch.tensor(1e-3, dtype=dtype)):
        blk_err, e_ij = block_errors(ids)
        floor = torch.maximum(pass_floor.to(dev), qt_floor)
        force = (blk_err > tol)[:, None] & acm & (e_ij > floor)
        ids = torch.where(force, torch.full_like(ids, C.ESCAPE), ids)
    blk_err, _ = block_errors(ids)
    return ids, ~torch.any(blk_err > tol)
