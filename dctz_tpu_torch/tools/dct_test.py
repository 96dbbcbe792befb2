"""Block-DCT round-trip checker (dct-test.c:18-231 + dct-fftw-test.c
equivalents).

Transforms a raw binary blockwise (64-element DCT-II), writes the
coefficients (.x) and the inverse-transformed reconstruction (.r), counts
elements whose |orig - rec| exceeds machine epsilon, and prints max_diff —
plus an independent-oracle check against scipy's whole-array DCT (the role
FFTW's REDFT10/01 played in dct-fftw-test.c).

The port of dctz_tpu.tools.dct_test: core/transform.forward and inverse at
the input's width (float64 for -d, float32 for -f), on the card unless
--device cpu is given.

Usage: python -m dctz_tpu_torch.tools.dct_test -d|-f <srcFile> <N>
           [--no-write] [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from . import pop_device


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    device = pop_device(argv, "dct_test")
    if device is None:
        return 2
    if len(argv) < 3 or argv[0] not in ("-d", "-f"):
        print(
            "usage: dct_test -d|-f <srcFile> <N> [--no-write] [--device cuda|cpu]",
            file=sys.stderr,
        )
        return 2
    dtype = np.float64 if argv[0] == "-d" else np.float32
    path, n = argv[1], int(argv[2])
    write = "--no-write" not in argv

    import torch

    from ..api import checked_device
    from ..core import transform

    device = checked_device(device)
    x = np.fromfile(path, dtype=dtype, count=n)
    if x.size != n:
        print("Error reading file", file=sys.stderr)
        return 1

    main_c, tail_c = transform.forward(torch.from_numpy(x).to(device), 64)
    coeffs = torch.cat([main_c.reshape(-1), tail_c]).cpu().numpy()
    rec = transform.inverse(main_c, tail_c).cpu().numpy()
    if write:
        coeffs.astype(dtype).tofile(path + ".x")
        rec.astype(dtype).tofile(path + ".r")

    eps = np.finfo(dtype).eps
    diff = np.abs(rec.astype(np.float64) - x.astype(np.float64))
    outliers = int((diff > eps).sum())
    print(f"number of elements exceeding epsilon: {outliers}")
    print(f"max_diff = {diff.max():e}")

    # independent oracle (dct-fftw-test role): scipy whole-block transform
    from scipy.fft import dct as scipy_dct

    n_full = n // 64
    want = scipy_dct(
        x[: n_full * 64].reshape(-1, 64).astype(np.float64),
        type=2,
        norm="ortho",
        axis=-1,
    ).reshape(-1)
    oracle_diff = np.abs(coeffs[: n_full * 64].astype(np.float64) - want).max()
    print(f"oracle(scipy) max_diff = {oracle_diff:e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
