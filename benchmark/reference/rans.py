"""Decoder of the static order-0 byte rANS blobs that v2 containers may
hold (a plane of a DC/AC section, the DPK exception section), written from
the blob layout alone:

    u32 0xFFFFFFFF | u32 n_chunks                      (interleaved layout)
    per chunk: u32 raw_len | u32 enc_len | u16 freq[256]
               | u32 state_a | u32 state_b | enc_len bytes
    (legacy: u32 n_chunks, one u32 state a chunk)

12-bit probabilities, 32-bit states renormalized a byte at a time below
2**23; in the interleaved layout even symbols come from state a and odd
ones from state b, both reading one forward byte stream.
"""

from __future__ import annotations

import struct

import numpy as np

PROB_BITS = 12
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 23


def _decode_chunk(enc: bytes, freq: list[int], sa: int, sb: int,
                  interleaved: bool, n: int) -> bytes:
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freq[s]
    if cum[256] != PROB_SCALE:
        raise ValueError("rANS chunk: frequencies do not sum to 4096")
    # per slot: its symbol, and the state step f * (x >> 12) + (slot - cum)
    sym, f_of, d_of = [0] * PROB_SCALE, [0] * PROB_SCALE, [0] * PROB_SCALE
    for s in range(256):
        for slot in range(cum[s], cum[s + 1]):
            sym[slot], f_of[slot], d_of[slot] = s, freq[s], slot - cum[s]
    # a valid stream never reads past its end; the padding keeps a corrupt
    # one from raising here (the container's crc has judged it already)
    enc = enc + bytes(8)
    out = bytearray(n)
    p = 0
    lo = RANS_L
    if not interleaved:
        x = sa
        for i in range(n):
            slot = x & 4095
            out[i] = sym[slot]
            x = f_of[slot] * (x >> 12) + d_of[slot]
            while x < lo:
                x = (x << 8) | enc[p]
                p += 1
        return bytes(out)
    a, b = sa, sb
    for i in range(0, n - 1, 2):
        slot = a & 4095
        out[i] = sym[slot]
        a = f_of[slot] * (a >> 12) + d_of[slot]
        if a < lo:
            a = (a << 8) | enc[p]
            p += 1
            if a < lo:
                a = (a << 8) | enc[p]
                p += 1
        slot = b & 4095
        out[i + 1] = sym[slot]
        b = f_of[slot] * (b >> 12) + d_of[slot]
        if b < lo:
            b = (b << 8) | enc[p]
            p += 1
            if b < lo:
                b = (b << 8) | enc[p]
                p += 1
    if n % 2:
        out[n - 1] = sym[a & 4095]
    return bytes(out)


def _job(args) -> bytes:
    return _decode_chunk(*args)


def decompress(blob: bytes | memoryview, pool=None) -> bytes:
    """The bytes a rANS blob holds. pool: an executor that decodes the
    blob's independent chunks in parallel (a process pool: the decode is
    Python), or None to decode them here one after another."""
    blob = bytes(blob)
    off = 0
    (n_chunks,) = struct.unpack_from("<I", blob, off)
    off += 4
    interleaved = n_chunks == 0xFFFFFFFF
    if interleaved:
        (n_chunks,) = struct.unpack_from("<I", blob, off)
        off += 4
    jobs = []
    for _ in range(n_chunks):
        raw_len, enc_len = struct.unpack_from("<II", blob, off)
        off += 8
        freq = [int(v) for v in np.frombuffer(blob, np.uint16, 256, off)]
        off += 512
        sa = struct.unpack_from("<I", blob, off)[0]
        off += 4
        sb = 0
        if interleaved:
            sb = struct.unpack_from("<I", blob, off)[0]
            off += 4
        if off + enc_len > len(blob):
            raise ValueError("rANS blob cut short")
        jobs.append((blob[off:off + enc_len], freq, sa, sb, interleaved, raw_len))
        off += enc_len
    if pool is not None:
        return b"".join(pool.map(_job, jobs))
    return b"".join(_job(j) for j in jobs)


def process_pool(workers: int | None = None):
    """A pool for decompress: spawned processes (the caller has threads and
    a CUDA context, which fork would copy), one a core unless `workers`;
    use it in a with statement so that every worker has ended when it
    closes."""
    import concurrent.futures
    import multiprocessing
    import os

    return concurrent.futures.ProcessPoolExecutor(
        max_workers=workers or os.cpu_count() or 1,
        mp_context=multiprocessing.get_context("spawn"))
