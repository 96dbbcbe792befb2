"""Chunk-row compaction and expansion as CUDA kernels (port of
dctz_tpu/ops/shuffle.py: compact_f32 and expand).

  H chunk_compact: the masked values of each (nc, cw) chunk row, moved to
                   the front in position order, into (nc, capc) rows
  I chunk_expand:  the inverse, rows back at the masked positions

The JAX package routes values through butterfly roll networks because the
TPU has no fast scatter; the kernels here rank the masked lanes of each row
with warp ballots (csrc/chunk_shuffle.cu). The plain versions are
ops/compaction.compact_rows and expand_rows. As in ops/dpk_fuse.py, a
wrapper takes the plain version for CPU tensors and launches the kernel for
CUDA tensors, or raises; it counts launches in dpk_fuse.LAUNCHES.
"""

from __future__ import annotations

import torch

from . import compaction as cp
from . import dpk_fuse


def _mask_u8(mask: torch.Tensor) -> torch.Tensor:
    """The mask as contiguous bytes (a bool tensor is viewed, not copied)."""
    mask = mask.contiguous()
    return mask.view(torch.uint8) if mask.dtype == torch.bool else mask


def _check_rows(mask: torch.Tensor, what: str) -> tuple[int, int]:
    if mask.dim() != 2 or mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"{what}: mask must be a 2-D bool or uint8 tensor")
    nc, cw = mask.shape
    if cw % 32:
        raise ValueError(f"{what}: row width {cw} is not a multiple of 32")
    return nc, cw


def compact_f32(mask: torch.Tensor, vals: torch.Tensor, capc: int):
    """Kernel H. mask (nc, cw) bool/u8, vals (nc, cw) float32 -> (rows (nc,
    capc) float32, zero-filled; counts (nc,) int32, the TRUE per-row counts,
    not clipped by capc). Unlike dctz_tpu's compact_f32, which returns the
    rows alone, the counts come out of the same pass."""
    if not dpk_fuse._on_cuda(mask, vals):
        return cp.compact_rows(mask.bool(), vals, capc)
    nc, cw = _check_rows(mask, "compact_f32")
    dpk_fuse._check(vals, torch.float32, "vals")
    if vals.shape != mask.shape or not 0 < capc <= cw:
        raise ValueError(f"compact_f32: vals {tuple(vals.shape)} against mask "
                         f"{tuple(mask.shape)}, capc {capc}")
    rows = torch.empty((nc, capc), dtype=torch.float32, device=vals.device)
    counts = torch.empty((nc,), dtype=torch.int32, device=vals.device)
    if nc:
        m = _mask_u8(mask)
        dpk_fuse._launch("chunk_compact", m.data_ptr(), vals.data_ptr(), nc,
                         cw, capc, rows.data_ptr(), counts.data_ptr())
    return rows, counts


def expand(mask: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Kernel I. rows[c, r] -> the r-th masked position of row c (0
    elsewhere, and past the row's capacity). rows: float32 or int32 (32-bit
    words; the kernel moves bits). Returns (nc, cw) of rows' dtype."""
    if not dpk_fuse._on_cuda(mask, rows):
        return cp.expand_rows(mask.bool(), rows)
    nc, cw = _check_rows(mask, "expand")
    if rows.dtype not in (torch.float32, torch.int32) or not rows.is_contiguous():
        raise TypeError("expand: rows must be contiguous float32 or int32")
    if rows.dim() != 2 or rows.shape[0] != nc or rows.shape[1] < 1:
        raise ValueError(f"expand: rows {tuple(rows.shape)} against mask "
                         f"{tuple(mask.shape)}")
    out = torch.empty((nc, cw), dtype=rows.dtype, device=rows.device)
    if nc:
        m = _mask_u8(mask)
        dpk_fuse._launch("chunk_expand", m.data_ptr(), rows.data_ptr(), nc, cw,
                         rows.shape[1], out.data_ptr())
    return out
