"""Orthonormal block DCT-II/III as matmuls (port of dctz_tpu/core/transform.py).

The basis is built exactly as the JAX package builds it: in float64 with
numpy, then rounded once to float32 (the port's tests assert byte equality).
These are the plain versions; the hot path's transforms run inside the CUDA
kernels of ops/dpk_fuse.py against the same float32 basis. The remainder
block of a length that is not a block multiple uses a rem-point basis, as
the JAX package's XLA chain does for its containers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _dct2_basis_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis B (n, n) in float64:
    B[k, m] = w(k) cos(pi (2m + 1) k / (2n)), w(0) = sqrt(1/n), else sqrt(2/n).
    Rows are the analysis vectors: coeffs = B @ x; x = B.T @ coeffs."""
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    basis = np.cos(np.pi * (2.0 * m + 1.0) * k / (2.0 * n))
    basis *= np.sqrt(2.0 / n)
    basis[0] /= np.sqrt(2.0)
    return basis


@functools.lru_cache(maxsize=32)
def _blockdiag_np(n: int, copies: int, forward: bool):
    """Block-diagonal stack of the basis (B.T blocks when forward)."""
    b = _dct2_basis_np(n)
    m = b.T if forward else b
    out = np.zeros((n * copies, n * copies), np.float64)
    for i in range(copies):
        out[i * n : (i + 1) * n, i * n : (i + 1) * n] = m
    return out


@functools.lru_cache(maxsize=32)
def _dct2_basis_on(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_dct2_basis_np(n).astype(np.float32)).to(device)


def dct2_basis(n: int, device) -> torch.Tensor:
    """The (n, n) float32 basis B[k, m] on `device`, built once per (n,
    device) and shared: callers must not write to it."""
    return _dct2_basis_on(n, torch.device(device))


def block_dct(blocks: torch.Tensor) -> torch.Tensor:
    """Forward DCT-II of a batch of float32 blocks: (..., n) -> (..., n)."""
    basis = dct2_basis(blocks.shape[-1], blocks.device)
    return torch.matmul(blocks, basis.T)


def block_idct(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse DCT (DCT-III) of a batch of blocks: (..., n) -> (..., n)."""
    basis = dct2_basis(coeffs.shape[-1], coeffs.device)
    return torch.matmul(coeffs, basis)


def inverse(main_c: torch.Tensor, tail_c: torch.Tensor) -> torch.Tensor:
    """Blockwise inverse of (full blocks (nblk, bs), tail (rem,)) -> flat."""
    main = block_idct(main_c).reshape(-1)
    if tail_c.shape[0] > 0:
        return torch.cat([main, block_idct(tail_c[None, :])[0]])
    return main
