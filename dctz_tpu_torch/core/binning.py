"""Zigzag-from-center bin ids in closed form (port of dctz_tpu/core/binning.py).

encode:  id = 2*(half - lin)        if lin <= half
         id = 2*(lin - half) - 1    if lin >  half
decode:  center = -(id//2)*w        if id even
         center = +((id//2)+1)*w    if id odd
"""

from __future__ import annotations

import torch


def linear_to_zigzag(lin: torch.Tensor, nbins: int) -> torch.Tensor:
    """Closed form of the reference conv_tbl[lin]; lin int32 in [0, nbins-1]."""
    half = nbins // 2
    return torch.where(lin <= half, 2 * (half - lin), 2 * (lin - half) - 1)


def zigzag_to_center(ids: torch.Tensor, bin_width: float,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Closed form of the reference bin_center[id] in `dtype` (ids int32)."""
    k = torch.div(ids, 2, rounding_mode="floor")
    tmp = torch.where(ids % 2 == 1, k + 1, -k)
    return tmp.to(dtype) * torch.tensor(bin_width, dtype=dtype,
                                        device=ids.device)
