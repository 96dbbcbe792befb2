"""Chunk-local stream compaction and expansion (port of
dctz_tpu/ops/compaction.py).

Streams are cut into chunk rows of `cw` elements; the masked values of each
row move to its front in position order and keep at most `capc` slots. The
JAX package did this with sorts or butterfly networks because the TPU has no
fast scatter; here the plain versions are a prefix sum plus a scatter or a
gather (compact_rows, expand_rows), and compact_chunked / expand_chunked
launch CUDA kernels H and I (ops/shuffle.py) for CUDA tensors at the chunk
widths and dtypes the kernels take (kernel_eligible), and run the plain
versions as torch ops elsewhere, on any device. The DPK
kernels of ops/dpk_fuse.py do the same work inside kernels B and C.
"""

from __future__ import annotations

import torch

CHUNK_W = 512  # elements per compaction chunk (8 DCT blocks)
CAPC = 128  # default escape capacity per chunk (fallback: CHUNK_W)


def compact_rows(mask2: torch.Tensor, vals2: torch.Tensor, capc: int):
    """Stable per-row compaction: (rows (nc, capc) zero-filled, counts (nc,)
    int32 — the TRUE per-row counts, not clipped by capc)."""
    nc, cw = mask2.shape
    rank = torch.cumsum(mask2.to(torch.int32), dim=1) - 1
    keep = mask2 & (rank < capc)
    idx = torch.where(keep, rank, torch.full_like(rank, capc)).to(torch.int64)
    out = torch.zeros((nc, capc + 1), dtype=vals2.dtype, device=vals2.device)
    out.scatter_(1, idx, torch.where(keep, vals2, torch.zeros_like(vals2)))
    counts = mask2.sum(dim=1, dtype=torch.int32)
    return out[:, :capc].contiguous(), counts


def expand_rows(mask2: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Inverse of compact_rows: the r-th masked position of row c receives
    rows[c, r] (0 elsewhere, and past the row's capacity)."""
    capc = rows.shape[1]
    rank = torch.cumsum(mask2.to(torch.int32), dim=1) - 1
    got = torch.gather(rows, 1, torch.clamp(rank, 0, capc - 1).to(torch.int64))
    return torch.where(mask2 & (rank < capc), got, torch.zeros_like(got))


def kernel_eligible(cw: int, dtype: torch.dtype,
                    dtypes=(torch.float32,)) -> bool:
    """Whether a chunk row of width cw and values of dtype takes kernel H
    (dtypes: float32) or I (float32 or int32): the kernels' own limits, a
    row width that is a multiple of 32 (shuffle._check_rows) and 32-bit
    values. Elsewhere (block size 48 at an odd number of 240-sample rows,
    the float64 values of full-width streams) the torch ops below run, the
    twin of the JAX package's sort, with the same bytes. The JAX package
    takes its Pallas kernels only at multiples of 128, a limit of the TPU's
    vector layout (dctz_tpu/ops/shuffle.py: eligible); both arms write the
    same bytes."""
    return cw % 32 == 0 and dtype in dtypes


def compact_chunked(flat_mask, flat_vals, cw: int = CHUNK_W, capc: int = CAPC):
    """(ac_chunks (n/cw, capc), counts (n/cw,), overflowed bool tensor);
    kernel H for CUDA tensors where kernel_eligible, else compact_rows."""
    from . import shuffle

    n = flat_mask.shape[0]
    assert n % cw == 0, (n, cw)
    mask2, vals2 = flat_mask.reshape(-1, cw), flat_vals.reshape(-1, cw)
    if kernel_eligible(cw, vals2.dtype):
        rows, counts = shuffle.compact_f32(mask2, vals2, capc)
    else:
        rows, counts = compact_rows(mask2.bool(), vals2, capc)
    return rows, counts, torch.any(counts > capc)


def expand_chunked(mask2: torch.Tensor, ac_chunks: torch.Tensor) -> torch.Tensor:
    """Values back at the masked positions of (nc, cw) mask rows; kernel I
    for CUDA tensors where kernel_eligible, else expand_rows."""
    from . import shuffle

    if kernel_eligible(mask2.shape[1], ac_chunks.dtype,
                       (torch.float32, torch.int32)):
        return shuffle.expand(mask2, ac_chunks)
    return expand_rows(mask2.bool(), ac_chunks)
