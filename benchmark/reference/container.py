"""Parsing of the containers the codec writes, from their byte layouts.

DTZS stream (segmented arrays):
    b"DTZS" | u16 version (1) | u16 reserved (0) | u64 total_elements
    repeat: u64 frame_len | one v2 container
    u64 0

v2 container ("DTZ2"):
    fixed header  <4sHHQdddQHHBxI: magic, version, flags, n, error bound,
                  scaling factor, mean, AC count, bins, block size, brsf
                  code, chunk bytes
    per section:  u32 chunk count | u32 sizes[count] | u32 crc32s[count]
    u32 crc32 of everything above (version 3)
    the sections' chunks in order, then the qtable (QT: block size values
    of the data's dtype)

A device-packed (DPK) container has six sections: widths, packed ids,
id exceptions, meta, DC, AC. The DC and AC sections of a container with
the plane flag start with a directory chunk (u8 item size, u8 method per
byte plane, u32 items, u16 chunk count per plane) followed by each plane's
chunks: method 0 raw, 1 zlib chunks, 2 one rANS blob, 3 zstd chunks.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import struct
import zlib

from . import rans

STREAM_MAGIC = b"DTZS"
V2_MAGIC = b"DTZ2"
_FIXED = struct.Struct("<4sHHQdddQHHBxI")

FLAG_QT = 1 << 0
FLAG_TRUNCATE = 1 << 1
FLAG_F64 = 1 << 2
FLAG_SHUFFLE = 1 << 3
FLAG_IDS4 = 1 << 4
FLAG_RANS = 1 << 5
FLAG_DPK = 1 << 6
FLAG_DPKZ = 1 << 7
FLAG_PLC = 1 << 8
FLAG_DPKR = 1 << 9
FLAG_ZST = 1 << 10
FLAG_DPKS = 1 << 11
FLAG_DCD = 1 << 12


@dataclasses.dataclass
class Container:
    flags: int
    n: int
    error_bound: float
    scaling_factor: float
    mean: float
    ac_count: int
    nbins: int
    block_size: int
    brsf: float
    sections: list  # per section, its list of chunk bytes
    qtable: bytes | None

    def has(self, flag: int) -> bool:
        return bool(self.flags & flag)


def frames(blob) -> tuple[int, list[memoryview]]:
    """(total elements, the frames' containers) of a DTZS stream."""
    mv = memoryview(blob)
    magic, version, reserved, total = struct.unpack_from("<4sHHQ", mv, 0)
    if magic != STREAM_MAGIC or version != 1 or reserved != 0:
        raise ValueError("not a version-1 DTZS stream")
    off, out = 16, []
    while True:
        if off + 8 > len(mv):
            raise ValueError("DTZS stream cut short")
        (length,) = struct.unpack_from("<Q", mv, off)
        off += 8
        if not length:
            break
        if off + length > len(mv):
            raise ValueError("DTZS frame cut short")
        out.append(mv[off:off + length])
        off += length
    if off != len(mv):
        raise ValueError("bytes after the DTZS end marker")
    return total, out


def parse(blob) -> Container:
    """A v2 container's header, sections and qtable; every crc checked."""
    mv = memoryview(blob)
    (magic, version, flags, n, eb, sf, mean, ac_count, nbins, bs, brsf_code,
     _chunk_bytes) = _FIXED.unpack_from(mv, 0)
    if magic != V2_MAGIC or version != 3:
        raise ValueError("not a version-3 v2 container")
    nsec = 6 if flags & FLAG_DPK else (4 if flags & FLAG_IDS4 else 3)
    off = _FIXED.size
    tables = []
    for _ in range(nsec):
        (count,) = struct.unpack_from("<I", mv, off)
        sizes = struct.unpack_from(f"<{count}I", mv, off + 4)
        crcs = struct.unpack_from(f"<{count}I", mv, off + 4 + 4 * count)
        off += 4 + 8 * count
        tables.append((sizes, crcs))
    (hdr_crc,) = struct.unpack_from("<I", mv, off)
    if zlib.crc32(mv[:off]) != hdr_crc:
        raise ValueError("header crc mismatch")
    off += 4
    sections = []
    for sizes, crcs in tables:
        chunks = []
        for size, crc in zip(sizes, crcs):
            chunk = bytes(mv[off:off + size])
            if len(chunk) != size or zlib.crc32(chunk) != crc:
                raise ValueError("chunk crc mismatch or chunk cut short")
            chunks.append(chunk)
            off += size
        sections.append(chunks)
    qtable = None
    if flags & FLAG_QT:
        isz = 8 if flags & FLAG_F64 else 4
        qtable = bytes(mv[off:off + bs * isz])
        off += bs * isz
    if off != len(mv):
        raise ValueError("container length does not match its tables")
    brsf = 1.0 if brsf_code == 0 else 2.0 ** ((brsf_code - 128) / 8.0)
    return Container(flags, n, eb, sf, mean, ac_count, nbins, bs, brsf,
                     sections, qtable)


def _zstd(chunk: bytes) -> bytes:
    import zstandard  # only a container with zstd-coded sections needs it

    return zstandard.ZstdDecompressor().decompress(chunk)


def side_section(c: Container, chunks: list) -> bytes:
    """A side section (DPK widths, exceptions, meta): zstd chunks with the
    zst flag, else zlib chunks."""
    dec = _zstd if c.has(FLAG_ZST) else zlib.decompress
    return b"".join(dec(ch) for ch in chunks)


def exception_section(c: Container, chunks: list, pool=None) -> bytes:
    if c.has(FLAG_ZST):
        return b"".join(_zstd(ch) for ch in chunks)
    if c.has(FLAG_RANS):
        return rans.decompress(b"".join(chunks), pool)
    return b"".join(zlib.decompress(ch) for ch in chunks)


def packed_section(c: Container, chunks: list) -> bytes:
    if c.has(FLAG_DPKZ) or c.has(FLAG_DPKR) or c.has(FLAG_DPKS):
        raise ValueError("host-coded DPK packed sections are not decoded here")
    return b"".join(chunks)


def float_section(c: Container, chunks: list, pool=None) -> tuple[int, list]:
    """(item size, byte planes) of a DC or AC section: plane-coded, or
    zlib chunks of the float stream, byte-shuffled (planes one after
    another) or not."""
    if c.has(FLAG_PLC):
        return plane_section(chunks, pool)
    import numpy as np

    isz = 8 if c.has(FLAG_F64) and not c.has(FLAG_TRUNCATE) else 4
    raw = np.frombuffer(b"".join(zlib.decompress(ch) for ch in chunks), np.uint8)
    if raw.size % isz:
        raise ValueError("float section length is not a whole number of items")
    planes = raw.reshape(isz, -1) if c.has(FLAG_SHUFFLE) else raw.reshape(-1, isz).T
    return isz, [p.tobytes() for p in planes]


def plane_section(chunks: list, pool=None) -> tuple[int, list[bytes]]:
    """(item size, byte planes) of a plane-coded DC or AC section; pool:
    rans.decompress's (the planes are then decoded side by side)."""
    d = chunks[0]
    isz = d[0]
    methods = d[1:1 + isz]
    (items,) = struct.unpack_from("<I", d, 1 + isz)
    counts = struct.unpack_from(f"<{isz}H", d, 5 + isz)
    subs, off = [], 1
    for k in counts:
        subs.append(chunks[off:off + k])
        off += k
    if off != len(chunks):
        raise ValueError("plane directory does not cover the section")

    def plane(m, sub):
        if m == 0:
            p = b"".join(sub)
        elif m == 1:
            p = b"".join(zlib.decompress(ch) for ch in sub)
        elif m == 2:
            p = rans.decompress(b"".join(sub), pool)
        elif m == 3:
            p = b"".join(_zstd(ch) for ch in sub)
        else:
            raise ValueError(f"unknown plane method {m}")
        if len(p) != items:
            raise ValueError("plane length does not match its directory")
        return p

    if pool is None:
        return isz, [plane(m, sub) for m, sub in zip(methods, subs)]
    with concurrent.futures.ThreadPoolExecutor(isz) as threads:
        return isz, list(threads.map(plane, methods, subs))
