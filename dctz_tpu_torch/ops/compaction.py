"""Chunk-local stream compaction and expansion (port of
dctz_tpu/ops/compaction.py).

Streams are cut into chunk rows of `cw` elements; the masked values of each
row move to its front in position order and keep at most `capc` slots. The
JAX package did this with sorts or butterfly networks because the TPU has no
fast scatter; here the plain versions are a prefix sum plus a scatter or a
gather (compact_rows, expand_rows), and compact_chunked / expand_chunked
launch CUDA kernels H and I (ops/shuffle.py) for CUDA tensors. The DPK
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


def compact_chunked(flat_mask, flat_vals, cw: int = CHUNK_W, capc: int = CAPC):
    """(ac_chunks (n/cw, capc), counts (n/cw,), overflowed bool tensor);
    kernel H for CUDA tensors."""
    from . import shuffle

    n = flat_mask.shape[0]
    assert n % cw == 0, (n, cw)
    rows, counts = shuffle.compact_f32(
        flat_mask.reshape(-1, cw), flat_vals.reshape(-1, cw), capc
    )
    return rows, counts, torch.any(counts > capc)


def expand_chunked(mask2: torch.Tensor, ac_chunks: torch.Tensor) -> torch.Tensor:
    """Values back at the masked positions of (nc, cw) mask rows; kernel I
    for CUDA tensors."""
    from . import shuffle

    return shuffle.expand(mask2, ac_chunks)
