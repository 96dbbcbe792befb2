"""The benchmark's input array, without importing bench.py (which loads jax).

climate_formula_np is a copy of bench.climate_formula_np: a deterministic
climate-shaped signal (smooth + small-scale detail + rare spikes) in float32
arithmetic. climate_formula_np64 evaluates the same formula in float64
arithmetic, so that its mantissas below float32 are real (it is not a cast
of the float32 array).
"""

from __future__ import annotations

import numpy as np


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


def climate_formula_np64(n: int) -> np.ndarray:
    return _climate_formula(n, np.float64)
