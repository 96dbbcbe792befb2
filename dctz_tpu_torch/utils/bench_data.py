"""The benchmark's input array, without importing bench.py (which loads jax).

climate_formula_np is a copy of bench.climate_formula_np: a deterministic
climate-shaped signal (smooth + small-scale detail + rare spikes) in float32
arithmetic. climate_formula_torch makes the same array on a device, as
bench.climate_formula_jax does (it differs from the host's by the sin ulps
of the two libraries). climate_formula_np64 evaluates the same formula in
float64 arithmetic, so that its mantissas below float32 are real (it is not
a cast of the float32 array).
"""

from __future__ import annotations

import numpy as np
import torch


def _climate_formula(n: int, dtype) -> np.ndarray:
    f = np.dtype(dtype).type
    t = np.arange(n, dtype=dtype)
    x = (
        np.sin(t * f(0.001)) * f(40.0)
        + np.sin(t * f(0.137)) * f(3.0)
        + np.sin(t * f(2.03)) * f(0.3)
    )
    spike = np.arange(n, dtype=np.int32) % 9973 == 0  # ~0.01% of elements
    return np.where(spike, x * f(8.0), x).astype(dtype)


def climate_formula_np(n: int) -> np.ndarray:
    return _climate_formula(n, np.float32)


def climate_formula_torch(n: int, device) -> torch.Tensor:
    """climate_formula_np(n) computed on `device` in float32 arithmetic."""
    t = torch.arange(n, dtype=torch.float32, device=device)
    x = (
        torch.sin(t * 0.001) * 40.0
        + torch.sin(t * 0.137) * 3.0
        + torch.sin(t * 2.03) * 0.3
    )
    spike = torch.arange(n, dtype=torch.int32, device=device) % 9973 == 0
    return torch.where(spike, x * 8.0, x)


def climate_formula_np64(n: int) -> np.ndarray:
    return _climate_formula(n, np.float64)
