"""QT pass 1 and the DPK QT encode pipeline (port of
dctz_tpu/ops/fused_encode.py: qtable_qmax and fused_encode_pipeline_dpk_qt_v2;
the non-DPK pipelines wait for ROADMAP item 8).

QT runs two passes over the input, as the reference does: pass 1 (kernel E,
qtable_qmax) reduces the per-position maximum |escaped AC coefficient| of the
whole array into the quantizer table, and pass 2 (kernels A + B with that
qtable) renormalizes the escapes through it.
"""

from __future__ import annotations

import torch

from ..config import CodecConfig
from ..core import constants as C
from ..core import quantize as qz
from ..core import transform
from . import dpk_fuse
from .repair import _SLACK

BS = dpk_fuse.BS


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def tolerance(x: torch.Tensor, n_true: int, error_bound: float) -> torch.Tensor:
    """The verify tolerance: (max - min over the n_true real samples of the
    zero-padded x) * eb * _SLACK, a float32 scalar on x's device."""
    xv = x[:n_true]
    return (torch.max(xv) - torch.min(xv)) * _f32(error_bound, x.device) * _f32(
        _SLACK, x.device
    )


def _qtable_qmax_plain(x: torch.Tensor, sf: torch.Tensor, cfg: CodecConfig):
    """Kernel E's plain version: the per-position max |coefficient| over
    the out-of-range AC positions of DCT(x / sf), unclamped; slot 0 is 0."""
    _, rmin, rmax = qz._geometry(cfg)
    coef = transform.block_dct((x / sf).reshape(-1, BS))
    dev = x.device
    escape = ~((coef >= _f32(rmin, dev)) & (coef <= _f32(rmax, dev)))
    escape[:, 0] = False
    mag = torch.where(escape, torch.abs(coef), torch.zeros_like(coef))
    return mag.amax(dim=0)


def qtable_qmax(x: torch.Tensor, sf: torch.Tensor,
                error_bound: float) -> torch.Tensor:
    """Kernel E (csrc/qtable_qmax.cu). Replaces the TPU kernel
    dctz_tpu/ops/fused_encode.py:_qtable_pass (line 203) behind qtable_qmax
    (line 229): QT pass 1 alone, the per-position max |escaped AC
    coefficient| of this array, clamped to >= 1.0 (the clamp is glue, as in
    the JAX package). Slot 0 carries no meaning here (1.0): the caller
    patches it with the last real block's DC, the reference quirk. The
    segmented writer max-reduces these across segments (max is
    associative, so that equals the whole-array pass).

    x: flat float32 (n_pad,), n_pad a multiple of 1024 (zero padding adds
    nothing: zero blocks have no escapes); sf: float32 scalar tensor on x's
    device. Returns the (64,) float32 qtable on x's device."""
    cfg = CodecConfig(mode="qt", error_bound=error_bound)
    n_pad = x.shape[0]
    if not dpk_fuse._on_cuda(x, sf):
        qmax = _qtable_qmax_plain(x, sf, cfg)
    else:
        dpk_fuse._check(x, torch.float32, "x")
        if x.dim() != 1 or n_pad % 1024:
            raise ValueError(f"x must be flat with a length that is a "
                             f"multiple of 1024, got shape {tuple(x.shape)}")
        _, rmin, rmax = qz._geometry(cfg)
        bits = torch.zeros((BS,), dtype=torch.int32, device=x.device)
        sf32 = sf.reshape(1).to(torch.float32).contiguous()
        basis = transform.dct2_basis(BS, x.device)
        dpk_fuse._launch("qtable_qmax", x.data_ptr(), basis.data_ptr(),
                         sf32.data_ptr(), n_pad, rmin, rmax, bits.data_ptr())
        qmax = bits.view(torch.float32)
    return torch.clamp_min(qmax, 1.0)


def patch_slot0(qtable: torch.Tensor, dc: torch.Tensor, n_true: int):
    """A copy of qtable whose slot 0 holds the DC of the last REAL block
    (the reference quirk, dctz_tpu/api.py:493-499; zero padding blocks do
    not count). The decoder never reads slot 0."""
    out = qtable.clone()
    out[0] = dc[-(-n_true // BS) - 1]
    return out


def fused_encode_pipeline_dpk_qt_v2(x: torch.Tensor, sf: torch.Tensor,
                                    error_bound: float, cape: int,
                                    n_true: int, verify: bool):
    """The reference's QT pipeline, kept for parity with it (api and
    stream run the same steps through stream._encode_segment_dpk): kernel
    E reduces the qtable (pass 1), then kernels A + B renormalize, verify
    and pack with it (pass 2). x is the zero-padded flat float32 input.
    Returns (width, packed, exc_rows, exc_counts, ac_rows,
    ac_counts, dc, overflow, ok, qtable), the qtable's slot 0 already
    patched with the last real block's DC."""
    cw = qz.chunk_width(x.shape[0], C.BLK_SZ)
    qtable = qtable_qmax(x, sf, error_bound)
    tol = tolerance(x, n_true, error_bound)
    out = dpk_fuse.encode_x_fused(
        x, sf, tol, n_true, error_bound, min(cape, cw), cw, verify, qtable
    )
    return out + (patch_slot0(qtable, out[6], n_true),)
