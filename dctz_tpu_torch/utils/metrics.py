"""Quality metrics (C13 parity).

Reference: calc_psnr (util.c:54-104) prints PSNR = 20*log10(range/RMSE) and
the max relative error maxdiff/range. Here the same quantities come back as a
structured dict (SURVEY.md §5 observability), plus the error-bound
satisfaction check the reference left disabled (util.c:96-102).
"""

from __future__ import annotations

import numpy as np


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


def psnr(original: np.ndarray, reconstructed: np.ndarray) -> float:
    """PSNR in dB over the value range (util.c:90-93)."""
    return evaluate(original, reconstructed, 0.0)["psnr_db"]


def ssim(
    original: np.ndarray,
    reconstructed: np.ndarray,
    window: int = 64,
    shape: tuple | None = None,
) -> float:
    """Windowed SSIM (Wang et al. 2004, uniform window) — the quality
    axis the reference's Z-Checker workflow computes externally (C19;
    reference README.md:98-127). K1=0.01 / K2=0.03, L = the original's
    value range; 1.0 for identical or constant data.

    Default: 1-D windows of `window` elements over the flat stream (the
    codec's natural block scale). shape=(rows, cols): 8x8 2-D windows
    over the field — the form Z-Checker applies to gridded data (the
    CESM-ATM suite; eval/harness passes the dataset dims)."""
    x = np.asarray(original).reshape(-1).astype(np.float64)
    y = np.asarray(reconstructed).reshape(-1).astype(np.float64)
    if x.size == 0 or np.array_equal(x, y):
        return 1.0
    L = float(x.max() - x.min())
    if L == 0.0:
        return 1.0
    c1 = (0.01 * L) ** 2
    c2 = (0.03 * L) ** 2

    if (
        shape is not None
        and len(shape) == 2
        and shape[0] * shape[1] == x.size
        and min(shape) >= 8
    ):
        w2 = 8
        x2 = x.reshape(shape)
        y2 = y.reshape(shape)

        def mov(a):
            c = np.pad(np.cumsum(np.cumsum(a, 0), 1), ((1, 0), (1, 0)))
            s = (
                c[w2:, w2:] - c[:-w2, w2:] - c[w2:, :-w2]
                + c[:-w2, :-w2]
            )
            return s / (w2 * w2)

        mx, my = mov(x2), mov(y2)
        vx = mov(x2 * x2) - mx * mx
        vy = mov(y2 * y2) - my * my
        cxy = mov(x2 * y2) - mx * my
    else:
        w = min(window, x.size)

        def mov(a):
            c = np.cumsum(np.concatenate(([0.0], a)))
            return (c[w:] - c[:-w]) / w

        mx, my = mov(x), mov(y)
        vx = mov(x * x) - mx * mx
        vy = mov(y * y) - my * my
        cxy = mov(x * y) - mx * my

    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
        (mx * mx + my * my + c1) * (vx + vy + c2)
    )
    return float(s.mean())
