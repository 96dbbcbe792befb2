"""Orthonormal block DCT-II/III as matmuls (port of dctz_tpu/core/transform.py).

The basis is built exactly as the JAX package builds it: in float64 with
numpy, then rounded once to float32 for float32 data (the port's tests
assert byte equality) and kept unrounded for float64 data.
The fused paths' transforms run inside the CUDA kernels (ops/dpk_fuse.py,
ops/fused_encode.py) against the same float32 basis. The matmuls here are
the plain versions, and also the device transforms of the generic chain and
of the verify-repair on the non-DPK containers, which the JAX package leaves
to XLA as well; on the card they run in full float32, never TF32, and a
float64 product is cuBLAS DGEMM (IEEE doubles with fused multiply-adds). The
remainder block of a length that is not a block multiple uses a rem-point
basis, as the JAX package's XLA chain does for its containers.

The forward transform takes CodecConfig.dct_precision: "highest" is the
float32 product, "high" the relaxed analysis of the JAX package, three
bfloat16 products with float32 accumulation (dot_bf16x3, the twin of
dctz_tpu/ops/dpk_fuse.py:_dot_bf16x3), for float32 data; float64 data
takes the float64 product at either precision, as dctz_tpu's matmul does on
its CPU and GPU backends, which ignore the precision flag for doubles. The
inverse is always the full product in the data's dtype.
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
def _dct2_basis_on(n: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    b = _dct2_basis_np(n)
    return torch.from_numpy(b if dtype == torch.float64
                            else b.astype(np.float32)).to(device)


def dct2_basis(n: int, device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The (n, n) basis B[k, m] on `device` in `dtype` (float32: rounded
    once; float64: the doubles unrounded), built once per (n, device, dtype)
    and shared: callers must not write to it."""
    return _dct2_basis_on(n, torch.device(device), dtype)


def _require_fp32_matmul(t: torch.Tensor) -> None:
    """A float32 matmul on the card must not run in TF32, which keeps about
    three decimal digits and would break the error bound. PyTorch's default
    is full float32 (allow_tf32 False); a caller may have flipped it. The
    switch does not touch float64 products."""
    if (t.is_cuda and t.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the codec's "
            "transforms need full float32 matmuls; set it to False"
        )


PRECISIONS = ("highest", "high")


def _split_bf16(a: torch.Tensor):
    """(hi, lo) float32 tensors holding bfloat16 values: hi = a rounded to
    bfloat16, lo = (a - hi) rounded to bfloat16, both to nearest even, as
    JAX's astype(bfloat16) rounds (a - hi is exact in float32)."""
    hi = a.to(torch.bfloat16).to(torch.float32)
    return hi, (a - hi).to(torch.bfloat16).to(torch.float32)


def dot_bf16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the JAX package's relaxed analysis computes it
    (dctz_tpu/ops/dpk_fuse.py:_dot_bf16x3, the meaning of
    lax.Precision.HIGH on a TPU): each operand split into bfloat16 hi and
    lo parts, then d(a_hi, b_lo) + d(a_lo, b_hi) + d(a_hi, b_hi), summed
    left to right. Each d is a float32 matmul of the bfloat16 values: their
    products are exact in float32, as preferred_element_type=float32 makes
    them in the reference (a bfloat16 matmul would round its output)."""
    _require_fp32_matmul(a)
    a_hi, a_lo = _split_bf16(a)
    b_hi, b_lo = _split_bf16(b)
    return (torch.matmul(a_hi, b_lo) + torch.matmul(a_lo, b_hi)
            + torch.matmul(a_hi, b_hi))


def block_dct(blocks: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """Forward DCT-II of a batch of blocks in their dtype: (..., n) ->
    (..., n). precision "high": the relaxed bfloat16x3 analysis
    (dot_bf16x3) for float32 blocks; float64 blocks take the float64
    product."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    _require_fp32_matmul(blocks)
    basis = dct2_basis(blocks.shape[-1], blocks.device, blocks.dtype)
    if precision == "high" and blocks.dtype == torch.float32:
        return dot_bf16x3(blocks, basis.T)
    return torch.matmul(blocks, basis.T)


def block_idct(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse DCT (DCT-III) of a batch of blocks in their dtype: (..., n)
    -> (..., n)."""
    _require_fp32_matmul(coeffs)
    basis = dct2_basis(coeffs.shape[-1], coeffs.device, coeffs.dtype)
    return torch.matmul(coeffs, basis)


def split_blocks(x: torch.Tensor, block_size: int):
    """(full blocks (N // bs, bs), tail (N % bs,)) of a flat array."""
    n_full = x.shape[0] // block_size
    return (x[: n_full * block_size].reshape(n_full, block_size),
            x[n_full * block_size :])


def forward(x: torch.Tensor, block_size: int, precision: str = "highest"):
    """Blockwise forward DCT of a flat array: (main (n_full, bs), tail
    (rem,)); the tail takes a rem-point basis, as the reference re-plans
    its remainder block. precision as in block_dct."""
    main, tail = split_blocks(x, block_size)
    if tail.shape[0] > 0:
        return (block_dct(main, precision),
                block_dct(tail[None, :], precision)[0])
    return block_dct(main, precision), tail


def inverse(main_c: torch.Tensor, tail_c: torch.Tensor) -> torch.Tensor:
    """Blockwise inverse of (full blocks (nblk, bs), tail (rem,)) -> flat."""
    main = block_idct(main_c).reshape(-1)
    if tail_c.shape[0] > 0:
        return torch.cat([main, block_idct(tail_c[None, :])[0]])
    return main
