"""Input statistics and scaling factor (port of dctz_tpu/core/stats.py).

sf = 10 ** (ceil(log10(max|x|)) - SF_ADJ_AMT), clamped to 1 for an all-zero
input. amax and the mean reduce in torch on the tensor's own device; sf is
then computed from amax on the CPU (scaling_factor).
"""

from __future__ import annotations

import math

import torch

from ..utils import timing


def scaling_factor(amax: torch.Tensor, sf_adj: int) -> torch.Tensor:
    """sf = 10**(ceil(log10(amax)) - sf_adj); 1.0 for amax == 0 (util.c:28,42),
    on amax's device. Computed on the CPU (one scalar copy each way): a
    card's log10 and pow round some of these values differently (float64
    torch.pow(10.0, -5.0) gives 9.999999999999999e-06 on an H100, 1e-05 on
    the CPU and in dctz_tpu), and sf is both the header's scaling factor
    and the divisor of every sample."""
    if amax.device.type != "cpu":
        return timing.to_device(_scaling_factor(timing.to_host(amax), sf_adj),
                                amax.device)
    return _scaling_factor(amax, sf_adj)


#: float64(log10(e)) as XLA's CPU compiler writes jnp.log10: log(x) times
#: this literal (its dumped HLO-to-LLVM program for f64), one ulp above
#: 1 / math.log(10) = 0.43429448190325176
_LOG10_E_F64 = 0.4342944819032518


def _scaling_factor(amax: torch.Tensor, sf_adj: int) -> torch.Tensor:
    """log10 as XLA compiles it on the CPU, whose ceiling dctz_tpu's
    scaling factor takes (torch's log10 crosses an integer elsewhere near
    some powers of ten): log(x) * (1 / ln 10) in float32, log(x) *
    _LOG10_E_F64 in float64."""
    dtype = amax.dtype
    safe = torch.clamp_min(amax, torch.finfo(dtype).tiny)
    if dtype == torch.float32:
        log10 = torch.log(safe) * torch.tensor(1.0 / math.log(10.0), dtype=dtype)
    else:
        log10 = torch.log(safe) * torch.tensor(_LOG10_E_F64, dtype=dtype)
    exp = torch.ceil(log10) - sf_adj
    ten = torch.tensor(10.0, dtype=dtype, device=amax.device)
    sf = torch.pow(ten, exp)
    return torch.where(amax > 0, sf, torch.ones_like(sf))


def amax_mean(x_padded: torch.Tensor, n_real: int):
    """(max|x|, mean) over a zero-padded flat array: pads never change max|x|,
    and the mean divides by the true count."""
    amax = torch.max(torch.abs(x_padded))
    mean = torch.sum(x_padded) / timing.scalar(
        float(n_real), x_padded.dtype, x_padded.device
    )
    return amax, mean
