"""Frozen copies of the program's quality arithmetic and codec constants,
so that a later change to the program cannot move the yardstick.

evaluate: copied from dctz_tpu_torch/utils/metrics.py (evaluate) at commit
57a9dd5. The constants: copied from dctz_tpu_torch/core/constants.py (BLK_SZ,
NBINS, ESCAPE, SF_ADJ_AMT, qt_factor for 255 bins) at commit 57a9dd5.
"""

from __future__ import annotations

import numpy as np

BLK_SZ = 64
NBINS = 255
ESCAPE = 255
SF_ADJ_AMT = 1
QT_FACTOR = 10.0  # qt_factor(255)


def evaluate(
    original: np.ndarray,
    reconstructed: np.ndarray,
    error_bound: float,
    compressed_nbytes: int | None = None,
) -> dict:
    """Compression-quality report for one array."""
    x = np.asarray(original).reshape(-1)
    r = np.asarray(reconstructed).reshape(-1).astype(x.dtype)
    diff = np.abs(x.astype(np.float64) - r.astype(np.float64))
    maxdiff = float(diff.max()) if diff.size else 0.0
    value_range = float(x.max() - x.min()) if x.size else 0.0
    mse = float(np.mean(diff * diff)) if diff.size else 0.0
    rmse = float(np.sqrt(mse))
    psnr = (
        float(20.0 * np.log10(value_range / rmse))
        if rmse > 0 and value_range > 0
        else float("inf")
    )
    max_rel_err = maxdiff / value_range if value_range > 0 else 0.0
    out = {
        "psnr_db": psnr,
        "rmse": rmse,
        "max_abs_err": maxdiff,
        "max_rel_err": max_rel_err,
        "bound_satisfied": bool(max_rel_err <= error_bound),
        "error_bound": error_bound,
        "num_elements": int(x.size),
    }
    if compressed_nbytes is not None:
        out["compressed_bytes"] = int(compressed_nbytes)
        out["ratio"] = float(x.size * x.dtype.itemsize) / max(compressed_nbytes, 1)
    return out
