"""The EC DPK encode pipeline (port of dctz_tpu/ops/fused_encode.py,
fused_encode_pipeline_dpk_ec only; the QT and non-DPK pipelines wait for
ROADMAP items 7 and 8)."""

from __future__ import annotations

import torch

from ..core import constants as C
from ..core.quantize import chunk_width
from . import dpk_fuse
from .repair import _SLACK


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def tolerance(x: torch.Tensor, n_true: int, error_bound: float) -> torch.Tensor:
    """The verify tolerance: (max - min over the n_true real samples of the
    zero-padded x) * eb * _SLACK, a float32 scalar on x's device."""
    xv = x[:n_true]
    return (torch.max(xv) - torch.min(xv)) * _f32(error_bound, x.device) * _f32(
        _SLACK, x.device
    )


def fused_encode_pipeline_dpk_ec(x: torch.Tensor, sf: torch.Tensor,
                                 error_bound: float, cape: int, n_true: int,
                                 verify: bool):
    """The verify tolerance, then kernels A + B (dpk_fuse.encode_x_fused).
    x is the zero-padded flat float32 input. Returns (width, packed,
    exc_rows, exc_counts, ac_rows, ac_counts, dc, overflow, ok)."""
    cw = chunk_width(x.shape[0], C.BLK_SZ)
    tol = tolerance(x, n_true, error_bound)
    return dpk_fuse.encode_x_fused(
        x, sf, tol, n_true, error_bound, min(cape, cw), cw, verify
    )
