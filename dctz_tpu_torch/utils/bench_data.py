"""The benchmark's input array, without importing bench.py (which loads jax).

A copy of bench.climate_formula_np: a deterministic climate-shaped signal
(smooth + small-scale detail + rare spikes) in float32 arithmetic.
"""

from __future__ import annotations

import numpy as np


def climate_formula_np(n: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float32)
    x = (
        np.sin(t * np.float32(0.001)) * np.float32(40.0)
        + np.sin(t * np.float32(0.137)) * np.float32(3.0)
        + np.sin(t * np.float32(2.03)) * np.float32(0.3)
    )
    spike = np.arange(n, dtype=np.int32) % 9973 == 0  # ~0.01% of elements
    return np.where(spike, x * np.float32(8.0), x).astype(np.float32)
