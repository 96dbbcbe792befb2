"""The least time of the work a configuration needs, and the chip's peaks.

The work is counted from shapes and the container's stream sizes, not from
the kernels that happen to run, so fusing or removing a kernel leaves it
true:

  encode  read the input once (4 bytes a sample); write the streams once
          (packed ids, id exceptions, tile widths, DC and AC values as
          float32); the forward 64-point transform of every block, and the
          inverse that verify=True needs, each as a 64 x 64 matrix product
          (2 * 64 FLOPs a sample).
  decode  read the streams once, write the output once (4 bytes a sample),
          one inverse transform.

Least time = max(bytes / peak bandwidth, FLOPs / peak fp32 rate).
"""

from __future__ import annotations

import struct
import zlib

PEAKS = {
    # NVIDIA H100 SXM data sheet, dense, at its 700 W limit
    "H100": {"bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12},
}
_META = struct.calcsize("<QHH2x")
FLOPS_PER_SAMPLE = 2 * 64  # one 64-point transform as a matrix product


def peaks(device_name: str) -> dict | None:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def stream_bytes(blob) -> tuple[int, int]:
    """(samples, bytes of the uncompressed streams) of a DPK v2 container
    or a DTZS stream of them, from headers and meta sections alone."""
    from ..reference import container as ct

    mv = memoryview(blob)
    views = ct.frames(mv)[1] if bytes(mv[:4]) == ct.STREAM_MAGIC else [mv]
    n_all = total = 0
    for v in views:
        c = ct.parse(v)
        dec = ct._zstd if c.has(ct.FLAG_ZST) else zlib.decompress
        meta = b"".join(dec(ch) for ch in c.sections[3])
        n_stream, tile_b, cw = struct.unpack_from("<QHH2x", meta, 0)
        nblk = -(-n_stream // c.block_size)
        nch = nblk * c.block_size // cw
        exc = sum(struct.unpack_from(f"<{nch}H", meta, _META))
        widths = -(-nblk // tile_b) * c.block_size
        packed = sum(len(ch) for ch in c.sections[1])
        total += packed + exc + widths + 4 * nblk + 4 * c.ac_count
        n_all += c.n
    return n_all, total


def least_seconds(kind: str, n: int, streams: int, device_name: str,
                  verify: bool = True):
    """(least seconds, "bytes" or "FLOPs": which bound) of one call."""
    p = peaks(device_name)
    if p is None:
        return None
    passes = 1 + int(kind == "compress" and verify)
    t_bytes = (4 * n + streams) / p["bytes_per_s"]
    t_flops = passes * FLOPS_PER_SAMPLE * n / p["fp32_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "FLOPs")
