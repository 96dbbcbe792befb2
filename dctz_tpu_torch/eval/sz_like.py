"""Minimal SZ-style error-bounded predictor codec — the head-to-head
comparator the reference's evaluation story assumes. A copy of
dctz_tpu.eval.sz_like (numpy only): the same bytes and the same decode.

The reference's whole quality argument is Z-Checker rate-distortion curves
against SZ and zfp (zc-patches/zc-ratedistortion.sh:40-48,
errBounds.cfg:12-22); neither binary is installable in this environment, so
this module implements the SZ-1.x core idea faithfully enough to anchor the
comparison with REAL (ratio, PSNR) points at each error bound:

  * linear predictor with decoded-value feedback (SZ's "curve fitting",
    1-D: pred = 2*x'[i-1] - x'[i-2]);
  * linear-scaling quantization of the prediction residual into 2^16
    symmetric bins of width 2*abs_eb — hits inside the radius reconstruct
    as pred + q*2*abs_eb (error <= abs_eb by construction);
  * misses ("unpredictable data") store the value verbatim as float32,
    exactly like SZ's binary-representation stage minus the leading-zero
    truncation;
  * zlib (level 6) over the quantization codes stands in for SZ's Huffman
    stage; exceptions get a separate zlib pass.

Pointwise bound: |x' - x| <= abs_eb = rel_eb * range(x) for predicted
points and f32-rounding for stored points — the same guarantee class dctz
offers with verify=True. Reconstruction feedback makes encode/decode
inherently sequential; this is a quality baseline, not a speed one (the
eval datasets are <= 1M points).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = b"SZL1"
_HDR = struct.Struct("<4sBxxxQdQQ")  # magic, dtype, n, abs_eb, ncodes?, nexc
RADIUS = 1 << 15  # 2^16 quantization bins, code 0 = unpredictable


def compress(x: np.ndarray, rel_eb: float) -> bytes:
    x = np.asarray(x).reshape(-1)
    src_is64 = x.dtype == np.float64
    xf = x.astype(np.float64)
    n = xf.shape[0]
    rng = float(xf.max() - xf.min()) if n else 0.0
    abs_eb = rel_eb * rng if rng > 0 else rel_eb
    w = 2.0 * abs_eb

    codes = np.empty(n, np.uint16)
    exceptions = []
    p1 = p2 = 0.0  # decoded feedback values
    for i in range(n):
        pred = 2.0 * p1 - p2 if i >= 2 else (p1 if i == 1 else 0.0)
        q = int(round((xf[i] - pred) / w)) if w > 0 else RADIUS
        if -RADIUS < q < RADIUS:
            dec = pred + q * w
            if abs(dec - xf[i]) <= abs_eb:
                codes[i] = q + RADIUS
                p2, p1 = p1, dec
                continue
        codes[i] = 0
        ex = np.float32(xf[i])
        exceptions.append(ex)
        p2, p1 = p1, float(ex)

    exc = np.asarray(exceptions, np.float32)
    czc = zlib.compress(codes.tobytes(), 6)
    cec = zlib.compress(exc.tobytes(), 6)
    head = _HDR.pack(
        MAGIC, 1 if src_is64 else 0, n, abs_eb, len(czc), len(exc)
    )
    return head + czc + cec


def decompress(blob: bytes) -> np.ndarray:
    magic, is64, n, abs_eb, nczc, nexc = _HDR.unpack_from(blob, 0)
    if magic != MAGIC:
        raise ValueError("not an sz_like container")
    off = _HDR.size
    codes = np.frombuffer(
        zlib.decompress(blob[off : off + nczc]), np.uint16, count=n
    )
    exc = np.frombuffer(
        zlib.decompress(blob[off + nczc :]), np.float32, count=nexc
    )
    w = 2.0 * abs_eb
    out = np.empty(n, np.float64)
    p1 = p2 = 0.0
    k = 0
    for i in range(n):
        c = int(codes[i])
        if c == 0:
            v = float(exc[k])
            k += 1
        else:
            pred = 2.0 * p1 - p2 if i >= 2 else (p1 if i == 1 else 0.0)
            v = pred + (c - RADIUS) * w
        out[i] = v
        p2, p1 = p1, v
    return out if is64 else out.astype(np.float32)
