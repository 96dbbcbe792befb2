"""Input statistics and scaling factor (port of dctz_tpu/core/stats.py).

sf = 10 ** (ceil(log10(max|x|)) - SF_ADJ_AMT), clamped to 1 for an all-zero
input. amax and the mean reduce in torch on the tensor's own device, so the
encode never leaves the device for them.
"""

from __future__ import annotations

import torch


def scaling_factor(amax: torch.Tensor, sf_adj: int) -> torch.Tensor:
    """sf = 10**(ceil(log10(amax)) - sf_adj); 1.0 for amax == 0 (util.c:28,42)."""
    dtype = amax.dtype
    safe = torch.clamp_min(amax, torch.finfo(dtype).tiny)
    exp = torch.ceil(torch.log10(safe)) - sf_adj
    ten = torch.tensor(10.0, dtype=dtype, device=amax.device)
    sf = torch.pow(ten, exp)
    return torch.where(amax > 0, sf, torch.ones_like(sf))


def amax_mean(x_padded: torch.Tensor, n_real: int):
    """(max|x|, mean) over a zero-padded flat array: pads never change max|x|,
    and the mean divides by the true count."""
    amax = torch.max(torch.abs(x_padded))
    mean = torch.sum(x_padded) / torch.tensor(
        float(n_real), dtype=x_padded.dtype, device=x_padded.device
    )
    return amax, mean
