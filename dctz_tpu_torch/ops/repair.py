"""Encode-side verify-and-repair, EC mode (port of dctz_tpu/ops/repair.py).

Reconstruct the array exactly as the decoder will, find blocks whose
pointwise error exceeds the tolerance, and force their error-carrying
coefficients to ESCAPE (EC stores the coefficient verbatim) in two passes
with falling floors (w/8, then w*1e-3); `ok` reports whether every block
then holds. This is the plain version of the verify half of kernel A
(ops/dpk_fuse.dct_quant_verify).
"""

from __future__ import annotations

import torch

from ..config import CodecConfig
from ..core import constants as C
from ..core import quantize as qz
from ..core import transform

_SLACK = 0.99  # verify against 0.99*tol: absorbs cross-backend ulp drift


def _reconstruct(ids, dc, dense, n_decode, cfg, sf):
    coeffs_hat = qz.decode_dense(ids, dc, dense, n_decode, cfg)
    bs = cfg.block_size
    n_full, rem = divmod(n_decode, bs)
    tail = coeffs_hat[n_full, :rem] if rem else coeffs_hat.new_zeros((0,))
    xhat = transform.inverse(coeffs_hat[:n_full], tail)
    return coeffs_hat, (xhat * sf)[:n_decode]


def verify_repair(x, coeffs, sf, bin_ids, dc, n_decode: int, n_valid: int,
                  cfg: CodecConfig, tol: torch.Tensor):
    """x: the input as the encoder saw it (length n_decode; positions >=
    n_valid are padding); coeffs: scaled-domain coefficients (nblk, bs);
    tol: the pre-slacked absolute tolerance (a float32 tensor). Returns
    (bin ids int32, ok bool tensor); EC stores escapes as the coefficients
    themselves, so there is no separate dense value grid."""
    if cfg.mode != "ec":
        raise NotImplementedError(
            "QT verify-repair is not ported yet (ROADMAP item 7)"
        )
    nblk, bs = coeffs.shape
    w, _, _ = qz._geometry(cfg)
    acm = qz.ac_mask(nblk, bs, n_decode, coeffs.device)
    valid = torch.arange(nblk * bs, device=coeffs.device).reshape(nblk, bs) < n_valid

    def block_errors(ids):
        coeffs_hat, xhat = _reconstruct(ids, dc, coeffs, n_decode, cfg, sf)
        err = torch.zeros(nblk * bs, dtype=torch.float32, device=x.device)
        err[:n_decode] = torch.abs(xhat - x[:n_decode])
        err = torch.where(valid, err.reshape(nblk, bs), torch.zeros_like(coeffs))
        return err.amax(dim=1), torch.abs(coeffs - coeffs_hat)

    ids = bin_ids.to(torch.int32)
    w32 = torch.tensor(w, dtype=torch.float32)
    for floor in (w32 / 8, w32 * torch.tensor(1e-3, dtype=torch.float32)):
        blk_err, e_ij = block_errors(ids)
        force = (blk_err > tol)[:, None] & acm & (e_ij > floor.to(coeffs.device))
        ids = torch.where(force, torch.full_like(ids, C.ESCAPE), ids)
    blk_err, _ = block_errors(ids)
    return ids, ~torch.any(blk_err > tol)
