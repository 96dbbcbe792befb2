"""Orthonormal block DCT-II/III as matmuls (port of dctz_tpu/core/transform.py).

The basis is built exactly as the JAX package builds it: in float64 with
numpy, then rounded once to float32 (the port's tests assert byte equality).
The fused paths' transforms run inside the CUDA kernels (ops/dpk_fuse.py,
ops/fused_encode.py) against the same float32 basis. The matmuls here are
the plain versions, and also the device transforms of the generic chain and
of the verify-repair on the non-DPK containers, which the JAX package leaves
to XLA as well; on the card they run in full float32, never TF32. The
remainder block of a length that is not a block multiple uses a rem-point
basis, as the JAX package's XLA chain does for its containers.
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


def _require_fp32_matmul(t: torch.Tensor) -> None:
    """A float32 matmul on the card must not run in TF32, which keeps about
    three decimal digits and would break the error bound. PyTorch's default
    is full float32 (allow_tf32 False); a caller may have flipped it."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the codec's "
            "transforms need full float32 matmuls; set it to False"
        )


def block_dct(blocks: torch.Tensor) -> torch.Tensor:
    """Forward DCT-II of a batch of float32 blocks: (..., n) -> (..., n)."""
    _require_fp32_matmul(blocks)
    basis = dct2_basis(blocks.shape[-1], blocks.device)
    return torch.matmul(blocks, basis.T)


def block_idct(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse DCT (DCT-III) of a batch of blocks: (..., n) -> (..., n)."""
    _require_fp32_matmul(coeffs)
    basis = dct2_basis(coeffs.shape[-1], coeffs.device)
    return torch.matmul(coeffs, basis)


def split_blocks(x: torch.Tensor, block_size: int):
    """(full blocks (N // bs, bs), tail (N % bs,)) of a flat array."""
    n_full = x.shape[0] // block_size
    return (x[: n_full * block_size].reshape(n_full, block_size),
            x[n_full * block_size :])


def forward(x: torch.Tensor, block_size: int):
    """Blockwise forward DCT of a flat array: (main (n_full, bs), tail
    (rem,)); the tail takes a rem-point basis, as the reference re-plans
    its remainder block."""
    main, tail = split_blocks(x, block_size)
    if tail.shape[0] > 0:
        return block_dct(main), block_dct(tail[None, :])[0]
    return block_dct(main), tail


def inverse(main_c: torch.Tensor, tail_c: torch.Tensor) -> torch.Tensor:
    """Blockwise inverse of (full blocks (nblk, bs), tail (rem,)) -> flat."""
    main = block_idct(main_c).reshape(-1)
    if tail_c.shape[0] > 0:
        return torch.cat([main, block_idct(tail_c[None, :])[0]])
    return main
