"""Chunk-row compaction and expansion as CUDA kernels (port of
dctz_tpu/ops/shuffle.py: compact_f32, expand, compact_unified and
compact_bytes).

  H chunk_compact:         the masked values of each (nc, cw) chunk row,
                           moved to the front in position order, into
                           (nc, capc) rows
  I chunk_expand:          the inverse, rows back at the masked positions
  J chunk_compact_unified: the masked id bytes of a row and, in the same
                           walk, the values of the ESCAPE bytes among them
  K chunk_compact_bytes:   H on uint8 values: J's exception half alone

The JAX package routes values through butterfly roll networks because the
TPU has no fast scatter; the kernels here rank the masked samples of each
row with warp scans (csrc/chunk_shuffle.cu). H, J and K have two
instantiations each, chosen by the shape of the call (walk_of): the word
walk (a 512-sample warp step, 16 mask bytes a lane, rows staged in shared
memory, persistent CTAs; J and K one template, K with J's AC half compiled
out) and the lane walk (chunk_compact_lanes, chunk_compact_unified_lanes,
chunk_compact_bytes_lanes: a warp ballot per 32 samples) for the rest; I
has the lane walk alone.
The plain versions are ops/compaction.compact_rows and expand_rows (J: two
compact_rows). As in ops/dpk_fuse.py, a wrapper takes the plain version for
CPU tensors and launches the kernel for CUDA tensors, or raises; it counts
launches in dpk_fuse.LAUNCHES (H, J and K per instantiation also in
dpk_fuse.INSTANTIATIONS).

As in the JAX package, J and K's output rows are min(capacity, cw) wide.
"""

from __future__ import annotations

import torch

from ..core import constants as C
from . import compaction as cp
from . import dpk_fuse


STEP = 512  # samples of a warp step of the word walk
#: bytes of the staged rows of a CTA's group, at most, in the word walk
#: (csrc/chunk_shuffle.cu: words::STAGE_MAX)
STAGE_MAX = 96 * 1024


def walk_of(cw: int, row_bytes: int, *ptrs: int) -> str:
    """Which instantiation of kernels H, J and K takes a call: "words", the
    word walk, where the chunk width cw is 64, 128, 256 or a multiple of
    512, every byte input's address in ptrs (the mask; J's id bytes and K's
    bytes too) starts on 16 bytes, and a group's rows of row_bytes each (H:
    4 capc, J: cape + 4 capc, K: capc) fit STAGE_MAX (a group: 8 rows above cw 512, else 8 *
    1024 / cw); else "lanes", the lane walk. The C entry points refuse the
    word walk where this rule does not give it."""
    if not (cw in (64, 128, 256) or (cw > 0 and cw % STEP == 0)):
        return "lanes"
    rows = 8 * (2 * STEP // cw) if cw <= STEP else 8
    fits = all(p % 16 == 0 for p in ptrs) and rows * row_bytes <= STAGE_MAX
    return "words" if fits else "lanes"


def _instantiation(kernel: str, walk: str) -> str:
    return kernel if walk == "words" else kernel + "_lanes"


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
        walk = walk_of(cw, 4 * capc, m.data_ptr())
        dpk_fuse._launch("chunk_compact", m.data_ptr(), vals.data_ptr(), nc,
                         cw, capc, rows.data_ptr(), counts.data_ptr(),
                         int(walk == "words"),
                         instantiation=_instantiation("chunk_compact", walk))
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


def compact_bytes(mask: torch.Tensor, byt: torch.Tensor, capc: int) -> torch.Tensor:
    """Kernel K. mask (nc, cw) bool/u8, byt (nc, cw) uint8 -> (nc, min(capc,
    cw)) uint8: each row's masked bytes in position order, zero-filled. The
    walk is walk_of's for rows of min(capc, cw) bytes and both inputs."""
    nc, cw = mask.shape
    width = min(capc, cw)
    if not dpk_fuse._on_cuda(mask, byt):
        return cp.compact_rows(mask.bool(), byt, width)[0]
    _check_rows(mask, "compact_bytes")
    dpk_fuse._check(byt, torch.uint8, "byt")
    if byt.shape != mask.shape or capc < 1:
        raise ValueError(f"compact_bytes: bytes {tuple(byt.shape)} against mask "
                         f"{tuple(mask.shape)}, capc {capc}")
    rows = torch.empty((nc, width), dtype=torch.uint8, device=byt.device)
    if nc:
        m = _mask_u8(mask)
        walk = walk_of(cw, width, m.data_ptr(), byt.data_ptr())
        dpk_fuse._launch("chunk_compact_bytes", m.data_ptr(), byt.data_ptr(), nc, cw,
                         width, rows.data_ptr(), int(walk == "words"),
                         instantiation=_instantiation("chunk_compact_bytes", walk))
    return rows


def _compact_unified_plain(mask, idb, vals, width_e: int, width_c: int, cut: int):
    m = mask.bool()
    exc, _ = cp.compact_rows(m, idb, width_e)
    rank = torch.cumsum(m.to(torch.int32), dim=1) - 1
    esc = m & (idb == C.ESCAPE) & (rank < cut)
    ac, _ = cp.compact_rows(esc, vals.to(torch.float32), width_c)
    return exc, ac


def compact_unified(mask: torch.Tensor, idb: torch.Tensor, vals: torch.Tensor,
                    cape: int, capc: int):
    """Kernel J. mask (nc, cw) bool/u8, idb (nc, cw) uint8 id bytes, vals
    (nc, cw) float32 -> (exc (nc, min(cape, cw)) uint8: the masked id bytes
    in position order; ac (nc, min(capc, cw)) float32: the values at the
    masked ESCAPE bytes whose exception rank is below the kernel capacity
    min(cw, cape rounded up to 128), the JAX kernel's cut), both zero-filled.
    The cut equals cape wherever cape is a multiple of 128 or at least cw,
    which is where idpack.pack_ids_with_ac's two arms agree."""
    nc, cw = mask.shape
    width_e, width_c = min(cape, cw), min(capc, cw)
    cut = min(cw, -(-cape // 128) * 128)
    if not dpk_fuse._on_cuda(mask, idb, vals):
        return _compact_unified_plain(mask, idb, vals, width_e, width_c, cut)
    _check_rows(mask, "compact_unified")
    dpk_fuse._check(idb, torch.uint8, "idb")
    dpk_fuse._check(vals, torch.float32, "vals")
    if (idb.shape != mask.shape or vals.shape != mask.shape or cape < 1
            or capc < 1):
        raise ValueError(f"compact_unified: idb {tuple(idb.shape)}, vals "
                         f"{tuple(vals.shape)} against mask {tuple(mask.shape)}")
    exc = torch.empty((nc, width_e), dtype=torch.uint8, device=vals.device)
    ac = torch.empty((nc, width_c), dtype=torch.float32, device=vals.device)
    if nc:
        m = _mask_u8(mask)
        walk = walk_of(cw, width_e + 4 * width_c, m.data_ptr(), idb.data_ptr())
        dpk_fuse._launch("chunk_compact_unified", m.data_ptr(), idb.data_ptr(),
                         vals.data_ptr(), nc, cw, width_e, width_c, cut,
                         exc.data_ptr(), ac.data_ptr(), int(walk == "words"),
                         instantiation=_instantiation("chunk_compact_unified", walk))
    return exc, ac
