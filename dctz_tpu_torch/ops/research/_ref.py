"""Card-only references of kernels L and M: csrc/fused_encode_dpk_ref.cu
and csrc/fused_decode_dpk_ref.cu, the first designs of the two kernels.

They keep the per-thread transforms of csrc/common.cuh (forward_dct,
inverse_dct) and the per-byte DPK stages of csrc/dpk_tile.cuh, so they stay
independent of the register-tiled transform (csrc/dct_tile.cuh) and the
word-wide stages and walks (csrc/dpk_stages.cuh, csrc/dpk_walk.cuh) that
kernels A-G and the redesigned L and M run. chip_smoke.py and
tests/test_torch_cuda.py hold those headers to them:

  L_ref = F -> idpack.pack_ids -> H   (the tiled forward transform)
  B on A (verify off) = L_ref         (B's word-wide stages)
  M_ref = C + D, C + D-QT at tile 256 (the tiled inverse transform)
  L = L_ref, M = M_ref                (the redesigned kernels)

Nothing in api, stream or ops calls them. Their launches do not count in
dpk_fuse.LAUNCHES: they are checks, not a path. Each takes the arguments of
the wrapper it checks; CPU tensors take that wrapper's plain version.
"""

from __future__ import annotations

import functools

import torch

from . import fused_decode, fused_encode_dpk


def _launch(name: str, *args) -> None:
    from ...kernels import build

    fn = getattr(build.lib(), "dctz_" + name)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


def fused_encode_dpk_ref(x: torch.Tensor, sf: torch.Tensor, error_bound: float):
    """Kernel L_ref: fused_encode_dpk.fused_encode_dpk's streams."""
    return fused_encode_dpk._encode(
        x, sf, error_bound, functools.partial(_launch, "fused_encode_dpk_ref"))


def fused_decode_dpk_ref(width, packed, exc_rows, dc, ac_rows, sf, n_stream: int,
                         b: int, cw: int, cfg, qtable: torch.Tensor | None = None):
    """Kernel M_ref: fused_decode.fused_decode_dpk's output."""
    return fused_decode._decode(
        width, packed, exc_rows, dc, ac_rows, sf, n_stream, b, cw, cfg, qtable,
        functools.partial(_launch, "fused_decode_dpk_ref"))
