"""Host-side entropy stage: zlib deflate/inflate.

Reference: three zlib streams (bin_index, DC, AC_exact) each deflated in its
own pthread (compress_thread, dctz-comp-lib.c:75-88, creation :651-703) with
deflateInit2(level=Z_DEFAULT_COMPRESSION(6), windowBits=15, memLevel=8)
(dctz-comp-lib.c:642-643); decompression inflates the three streams
sequentially (dctz-decomp-lib.c:244-322).

CPython's zlib releases the GIL, so a thread pool reproduces (and generalizes)
the reference's 3-way parallelism. For the v2 container each stream is split
into fixed-size chunks deflated independently, which scales compression AND
decompression across all host cores instead of 3/1 threads. When the native
extension (cpp/) is built, its pthread-pool codec is used instead; the Python
pool is the portable fallback — same byte streams either way.
"""

from __future__ import annotations

import concurrent.futures
import os
import zlib
from typing import Sequence

from ..utils import timing

_MEM_LEVEL = 8  # DEF_MEM_LEVEL (dctz-comp-lib.c:25)
_WBITS = 15  # windowBits (dctz-comp-lib.c:642)


class _Pool(concurrent.futures.ThreadPoolExecutor):
    """A thread pool whose tasks run in the submitting thread's tracing
    context (utils/timing.carry): their spans join the caller's timer and
    their CPU seconds the entropy layer's."""

    def submit(self, fn, /, *args, **kwargs):
        return super().submit(timing.carry(fn), *args, **kwargs)


_POOL: _Pool | None = None


def _pool() -> _Pool:
    global _POOL
    if _POOL is None:
        _POOL = _Pool(
            max_workers=max(3, os.cpu_count() or 1),
            thread_name_prefix="dctz-zlib",
        )
    return _POOL


_SECTION_POOL: _Pool | None = None


def section_pool() -> _Pool:
    """Executor for container-SECTION-level tasks (width/packed/exc/meta/DC/AC
    coded concurrently). Deliberately separate from the chunk pool: section
    tasks block on chunk futures, and sharing one bounded pool for both
    levels can deadlock (every worker parked in a section task, none left
    for the chunks it waits on). Section tasks themselves never submit to
    this pool. The codecs (zlib, native rANS/filters) release the GIL, so
    sections genuinely overlap; output bytes are unchanged because assembly
    order is preserved at the gather points."""
    global _SECTION_POOL
    if _SECTION_POOL is None:
        _SECTION_POOL = _Pool(
            max_workers=8, thread_name_prefix="dctz-sect"
        )
    return _SECTION_POOL


HUFFMAN_ONLY = zlib.Z_HUFFMAN_ONLY


try:  # pragma: no cover - exercised implicitly everywhere
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None


def zstd_available() -> bool:
    return _zstd is not None


def zstd_compress(data: bytes | memoryview, level: int = 1) -> bytes:
    return _zstd.ZstdCompressor(level=level).compress(data)


def zstd_decompress(blob: bytes | memoryview) -> bytes:
    if _zstd is None:
        raise RuntimeError(
            "container uses zstd-coded sections but the 'zstandard' package "
            "is not installed"
        )
    return _zstd.ZstdDecompressor().decompress(blob)


_ZSTD_CHUNK = 1 << 19


def _zstd_crc(c, level):
    z = zstd_compress(c, level)
    return z, zlib.crc32(z)


def chunked_zstd(
    data: bytes | memoryview, chunk_bytes: int, level: int = 1
) -> list[bytes]:
    """Split into fixed-size chunks and zstd-code each independently (the
    v2 parallel-section layout, same shape as chunked_deflate). The
    returned ChunkList carries each chunk's crc32, computed in the same
    pool task (pack_v2 skips its crc pass)."""
    data = memoryview(data)
    chunk_bytes = min(chunk_bytes, _ZSTD_CHUNK)
    chunks = [
        data[off : off + chunk_bytes] for off in range(0, len(data), chunk_bytes)
    ]
    futs = [_pool().submit(_zstd_crc, c, level) for c in chunks]
    out = ChunkList()
    out.crcs = []
    for f in futs:
        z, crc = f.result()
        out.append(z)
        out.crcs.append(crc)
    return out


def chunked_unzstd(chunks: Sequence[bytes], out=None):
    """The joined bytes of a chunked zstd section; out (a writable 1-D
    uint8 array the section must fill exactly, join_into) takes them in
    place of the join and is returned."""
    if not chunks:
        return b"" if out is None else join_into((), out)
    verify_chunk_range(chunks)
    futs = [_pool().submit(zstd_decompress, c) for c in chunks]
    pieces = (f.result() for f in futs)
    return b"".join(pieces) if out is None else join_into(pieces, out)


_CRC_PAR_MIN = 1 << 16  # below this, pool dispatch costs more than the crc


class ChunkList(list):
    """See the JAX package's counterpart of this function."""

    __slots__ = ("crcs", "expected_crcs")


def resolve_crcs(chunks) -> list[int] | None:
    """The producer-attached crcs of a ChunkList (resolving futures), or
    None when the list carries none."""
    crcs = getattr(chunks, "crcs", None)
    if crcs is None or len(crcs) != len(chunks):
        return None
    return [
        (c.result() if hasattr(c, "result") else c) & 0xFFFFFFFF
        for c in crcs
    ]


#: DC-delta restart interval in items (= one DPK tile of blocks): every
#: DC_RESTART-th value stores the absolute mapped u32, so tile-aligned
#: range decodes (multi-host monolithic slices) invert locally.
DC_RESTART = 256

_U32_SIGN = None  # lazy numpy constants (numpy import is deferred here)


def f32_delta(dc) -> "np.ndarray":
    """Order-preserving-u32 delta of a float32 stream (container.Header.dcd).

    Each value maps to the standard monotone u32 code (negative floats
    bit-inverted, positives get the sign bit set) and stores its wrapping
    difference from the previous item; restarts every DC_RESTART. Returns
    a float32-VIEWED array of the same length (a bit container — the
    section codecs below see plain f32 bytes). Exactly inverted by
    f32_delta_inv."""
    import numpy as np

    a = np.ascontiguousarray(dc, np.float32)
    u = a.view(np.uint32)
    m = np.where(
        (u >> 31) != 0, ~u, u | np.uint32(0x80000000)
    ).astype(np.uint32)
    d = m.copy()
    d[1:] -= m[:-1]
    d[:: DC_RESTART] = m[:: DC_RESTART]
    return d.view(np.float32)


def f32_delta_inv(d) -> "np.ndarray":
    """Inverse of f32_delta. The input's item 0 must sit on a restart
    boundary of the original stream (all decode paths slice at DPK-tile
    multiples of DC_RESTART blocks)."""
    import numpy as np

    a = np.ascontiguousarray(d, np.float32).view(np.uint32)
    n = a.size
    k = -(-n // DC_RESTART)
    pad = k * DC_RESTART - n
    m2 = np.concatenate([a, np.zeros(pad, np.uint32)]) if pad else a
    m = np.cumsum(
        m2.reshape(k, DC_RESTART), axis=1, dtype=np.uint32
    ).reshape(-1)[:n]
    u = np.where(
        (m >> 31) != 0, m & np.uint32(0x7FFFFFFF), ~m
    ).astype(np.uint32)
    return u.view(np.float32)


def verify_chunk_range(chunks, k0: int = 0, k1: int | None = None) -> None:
    """See the JAX package's counterpart of this function."""
    want = getattr(chunks, "expected_crcs", None)
    if want is None:
        return
    if k1 is None:
        k1 = len(chunks)
    k0 = max(k0, 0)
    got = crc32_many(chunks[k0:k1])
    for i, (g, w) in enumerate(zip(got, want[k0:k1])):
        if g != w:
            raise ValueError(
                f"corrupted container: crc mismatch in chunk {k0 + i}"
            )


def verify_covering_chunks(chunks, b0: int, b1: int) -> None:
    """verify_chunk_range over the chunks covering byte range [b0, b1) of
    a section whose DECODED offsets equal its STORED offsets (verbatim /
    raw-plane sections; uniform chunk size learned from chunk 0, the last
    chunk may be short). Shared by the range-decode paths so the window
    arithmetic lives in one place."""
    if not chunks:
        return
    cb = len(chunks[0])
    if len(chunks) == 1 or cb == 0:
        verify_chunk_range(chunks)
        return
    verify_chunk_range(
        chunks, min(b0 // cb, len(chunks) - 1),
        min(len(chunks), -(-b1 // cb)),
    )


def crc32_many(chunks: Sequence[bytes]) -> list[int]:
    """crc32 of each chunk; large chunks hash on the thread pool."""
    futs = {
        i: _pool().submit(zlib.crc32, c)
        for i, c in enumerate(chunks)
        if len(c) >= _CRC_PAR_MIN
    }
    return [
        (futs[i].result() if i in futs else zlib.crc32(c)) & 0xFFFFFFFF
        for i, c in enumerate(chunks)
    ]


def deflate(
    data: bytes | memoryview, level: int = 6, strategy: int = 0
) -> bytes:
    """One zlib stream with reference-identical parameters (strategy 0 ==
    Z_DEFAULT_STRATEGY; HUFFMAN_ONLY for pre-packed low-entropy streams)."""
    co = zlib.compressobj(level, zlib.DEFLATED, _WBITS, _MEM_LEVEL, strategy)
    # zlib accepts any 1-D contiguous buffer — no bytes() copy needed
    return co.compress(data) + co.flush()


def inflate(data: bytes | memoryview, expected_size: int | None = None) -> bytes:
    return zlib.decompress(data, _WBITS, expected_size or 0)


def deflate_streams(
    streams: Sequence[bytes | memoryview], level: int = 6, strategy: int = 0
) -> list[bytes]:
    """Deflate several independent streams in parallel (C9 parity)."""
    def _task(s):
        z = deflate(s, level, strategy)
        return z, zlib.crc32(z)

    futs = [_pool().submit(_task, s) for s in streams]
    out = ChunkList()
    out.crcs = []
    for f in futs:
        z, crc = f.result()
        out.append(z)
        out.crcs.append(crc)
    return out


def inflate_streams(streams: Sequence[bytes | memoryview]) -> list[bytes]:
    futs = [_pool().submit(inflate, s) for s in streams]
    return [f.result() for f in futs]


def pack_ids4(ids: bytes | memoryview) -> tuple[bytes, bytes]:
    """Nibble-pack the bin-index stream (v2 IDS4 filter)."""
    import numpy as np

    a = np.frombuffer(data_bytes := bytes(ids), np.uint8)
    tail = b""
    if a.size % 2:
        tail = data_bytes[-1:]
        a = a[:-1]
    from .. import native

    if native.available():
        packed, exceptions = native.pack_ids4(a)
        return packed, exceptions + tail
    small = a <= 14
    nib = np.where(small, a, np.uint8(15))
    packed = (nib[0::2] | (nib[1::2] << 4)).tobytes()
    exceptions = a[~small].tobytes() + tail
    return packed, exceptions


def unpack_ids4(packed: bytes, exceptions: bytes, n: int) -> bytes:
    """Inverse of pack_ids4; n is the original stream length."""
    import numpy as np

    odd = n % 2
    p = np.frombuffer(packed, np.uint8)
    exc = np.frombuffer(exceptions, np.uint8)
    tail = exc[-1:] if odd else None
    if odd:
        exc = exc[:-1]
    from .. import native

    if native.available():
        out = native.unpack_ids4(p, np.ascontiguousarray(exc), n - odd)
        return out.tobytes() + (tail.tobytes() if odd else b"")
    out = np.empty(n - odd, np.uint8)
    out[0::2] = p & 15
    out[1::2] = p >> 4
    mask = out == 15
    out[mask] = exc
    if odd:
        out = np.concatenate([out, tail])
    return out.tobytes()


def shuffle_bytes(data: bytes | memoryview, itemsize: int) -> bytes:
    """HDF5-style byte shuffle: fixed-size items -> per-byte planes."""
    import numpy as np

    a = np.frombuffer(data, np.uint8)
    if a.size % itemsize:
        return bytes(data)  # not item-aligned; store as-is
    from .. import native

    if native.available():
        return native.shuffle(a, itemsize)
    return np.ascontiguousarray(a.reshape(-1, itemsize).T).tobytes()


def unshuffle_bytes(data: bytes | memoryview, itemsize: int) -> bytes:
    import numpy as np

    a = np.frombuffer(data, np.uint8)
    if a.size % itemsize:
        return bytes(data)
    from .. import native

    if native.available():
        return native.unshuffle(a, itemsize)
    return np.ascontiguousarray(a.reshape(itemsize, -1).T).tobytes()


def join_into(pieces, out) -> "np.ndarray":
    """Copy byte pieces back to back into out, a writable 1-D uint8 array
    that they must fill exactly (a section decoding to another length is
    corrupt) -> out: the copy a b"".join makes, into the bytes' final
    place."""
    import numpy as np

    o, n = 0, out.size
    for p in pieces:
        m = len(p)
        if o + m > n:
            break
        out[o : o + m] = np.frombuffer(p, np.uint8)
        o += m
    else:
        if o == n:
            return out
    raise ValueError(f"corrupted container: a section does not decode to "
                     f"its {n} bytes")


def join_chunks(chunks: Sequence[bytes | memoryview]) -> bytes | memoryview:
    """b"".join that detects consecutive memoryviews over one base object
    (the parse_v2 zero-copy layout) and returns a single view instead of
    copying — stored-verbatim DPK sections never leave the container
    buffer this way."""
    if len(chunks) == 1:
        return chunks[0]
    if chunks and all(isinstance(c, memoryview) for c in chunks):
        base = chunks[0].obj
        if all(c.obj is base for c in chunks):
            import numpy as np

            whole = np.frombuffer(base, np.uint8)
            offs = [
                np.frombuffer(c, np.uint8).ctypes.data - whole.ctypes.data
                for c in chunks
            ]
            if all(
                offs[i] + len(chunks[i]) == offs[i + 1]
                for i in range(len(chunks) - 1)
            ):
                start = offs[0]
                end = offs[-1] + len(chunks[-1])
                return memoryview(base)[start:end]
    return b"".join(chunks)


def decode_chunk_range(chunks, b0: int, b1: int, decode_one):
    """Decode only the chunks of a fixed-chunk-size section covering DECODED
    byte range [b0, b1) and return exactly those bytes. The decoded chunk
    size is learned from chunk 0 (every chunk but the last decodes to the
    same size by construction of chunked_deflate/chunked_zstd) — no
    pack-time configuration needed. Used by the multi-host slice decode:
    a host touches only its share of the bulk section."""
    if not chunks or b1 <= b0:
        return b""
    verify_chunk_range(chunks, 0, 1)  # chunk 0 always decodes (dec_cs)
    first = decode_one(chunks[0])
    dec_cs = len(first)
    if len(chunks) == 1 or dec_cs == 0:
        return memoryview(first)[b0:b1]
    k0 = min(b0 // dec_cs, len(chunks) - 1)
    k1 = min(len(chunks), -(-b1 // dec_cs))
    if k0 > 0:
        verify_chunk_range(chunks, k0, k1)
    elif k1 > 1:
        verify_chunk_range(chunks, 1, k1)
    parts = [
        first if k == 0 else decode_one(chunks[k]) for k in range(k0, k1)
    ]
    data = parts[0] if len(parts) == 1 else b"".join(parts)
    off = b0 - k0 * dec_cs
    return memoryview(data)[off : off + (b1 - b0)]


def take_row_prefixes(rows, lens) -> "np.ndarray":
    """Gather lens[i] leading items of each capacity row into a tight 1-D
    array (any itemsize). The threaded native memcpy loop when available;
    the numpy boolean extract otherwise — identical bytes."""
    import numpy as np

    rows = np.ascontiguousarray(rows)
    lens = np.asarray(lens, np.int64)
    from .. import native

    if native.available():
        isz = rows.dtype.itemsize
        flat = rows.view(np.uint8).reshape(rows.shape[0], -1)
        return native.pack_rows(flat, lens * isz).view(rows.dtype)
    mask = np.arange(rows.shape[1])[None, :] < lens[:, None]
    return rows[mask]


def pad_row_prefixes(tight, lens, cap: int, dtype) -> "np.ndarray":
    """Inverse of take_row_prefixes -> zero-padded (len(lens), cap) rows."""
    import numpy as np

    dtype = np.dtype(dtype)
    lens = np.asarray(lens, np.int64)
    tight = np.frombuffer(tight, dtype) if isinstance(tight, (bytes, memoryview)) else np.ascontiguousarray(tight, dtype)
    from .. import native

    if native.available():
        rows = native.unpack_rows(
            tight.view(np.uint8), lens * dtype.itemsize, cap * dtype.itemsize
        )
        return rows.view(dtype).reshape(lens.size, cap)
    rows = np.zeros((lens.size, cap), dtype)
    rows[np.arange(cap)[None, :] < lens[:, None]] = tight
    return rows



_PLC_SAMPLE = 1 << 16
_PLC_MIN_GAIN = 0.03
_PLC_RANS_MIN = 1 << 16
_PLC_RANS_SLACK = 1.05
_PLC_ZSTD_LEVEL = 2


def _plc_method(plane: memoryview, level: int, use_zlib: bool = False) -> int:
    """See the JAX package's counterpart of this function."""
    import numpy as np

    sample = bytes(plane[:_PLC_SAMPLE])
    if not sample:
        return 0
    cnt = np.bincount(np.frombuffer(sample, np.uint8), minlength=256)
    p = cnt[cnt > 0] / len(sample)
    if float(-(p * np.log2(p)).sum()) >= 7.95:
        return 0
    if not use_zlib and zstd_available():
        zlen = len(zstd_compress(sample, _PLC_ZSTD_LEVEL))
        return 3 if zlen < len(sample) * (1.0 - _PLC_MIN_GAIN) else 0
    dlen = len(deflate(sample, 1))
    if dlen >= len(sample) * (1.0 - _PLC_MIN_GAIN):
        return 0
    if len(plane) >= _PLC_RANS_MIN:
        from .. import native

        if native.available():
            rlen = len(native.rans_compress(sample))
            if rlen <= dlen * _PLC_RANS_SLACK:
                return 2
    return 1


def encode_float_stream(
    data: bytes | memoryview,
    itemsize: int,
    chunk_bytes: int,
    level: int = 6,
    use_zlib: bool = False,
) -> list[bytes]:
    """Encode a float stream as per-plane sections (see module comment).

    use_zlib=True restricts methods to the zlib/rANS set (byte parity with
    pre-zstd containers, CodecConfig.host_codec="zlib")."""
    import struct

    data = memoryview(data)
    n = len(data)
    if itemsize < 1 or n % itemsize:
        itemsize = 1  # degenerate: one plane over the raw bytes
    items = n // itemsize
    shuffled = memoryview(shuffle_bytes(data, itemsize)) if itemsize > 1 else data
    planes = [shuffled[i * items : (i + 1) * items] for i in range(itemsize)]
    return encode_float_planes(planes, chunk_bytes, level, use_zlib)


def encode_float_planes(
    planes, chunk_bytes: int, level: int = 6, use_zlib: bool = False
) -> list[bytes]:
    """encode_float_stream body for ALREADY-SPLIT byte planes (u8 buffers,
    one per byte of the item). The device-plane encode path
    (api._plane_split2) lands here directly — the section bytes are
    IDENTICAL to the host-shuffled route because the shuffle is exactly
    this plane split."""
    import struct

    itemsize = len(planes)
    items = len(planes[0])
    methods = bytearray(itemsize)
    chunk_bytes = min(chunk_bytes, 1 << 17)
    # probe all planes concurrently (independent samples), then submit
    # EVERY coding task before gathering any — cross-plane parallelism.
    # On the 4-core dev host this measures ~flat (pool already saturated;
    # VM noise dominates) but it removes the serial-per-plane structure
    # that would idle a production host's wider pool. Chunk tasks are
    # submitted from this thread only (never from inside a pool worker —
    # nested gathers on the same pool can deadlock); raw planes stay
    # ZERO-COPY views of the shuffled buffer.
    m_futs = [
        _pool().submit(_plc_method, p, level, use_zlib) for p in planes
    ]
    for i, f in enumerate(m_futs):
        methods[i] = f.result()

    def _dfl_task(c):
        z = deflate(c, level, 0)
        return z, zlib.crc32(z)

    chunk_futs: list = [None] * itemsize
    single_futs: list = [None] * itemsize
    for i, p in enumerate(planes):
        if methods[i] == 3:
            cs = [
                p[o : o + chunk_bytes] for o in range(0, len(p), chunk_bytes)
            ]
            chunk_futs[i] = [
                _pool().submit(_zstd_crc, c, _PLC_ZSTD_LEVEL) for c in cs
            ]
        elif methods[i] == 2:
            from .. import native

            single_futs[i] = _pool().submit(
                lambda q=p: [native.rans_compress(bytes(q))]
            )
        elif methods[i] == 1:
            cs = [
                p[o : o + chunk_bytes] for o in range(0, len(p), chunk_bytes)
            ]
            chunk_futs[i] = [_pool().submit(_dfl_task, c) for c in cs]

    out_planes: list[list[bytes]] = []
    for i, p in enumerate(planes):
        if chunk_futs[i] is not None:
            ol = ChunkList()
            ol.crcs = []
            for f in chunk_futs[i]:
                z, crc = f.result()
                ol.append(z)
                ol.crcs.append(crc)
            out_planes.append(ol)
        elif single_futs[i] is not None:
            out_planes.append(single_futs[i].result())
        else:
            out_planes.append([p])  # raw: zero-copy view
    directory = struct.pack("<B", itemsize) + bytes(methods)
    directory += struct.pack("<I", items)
    directory += struct.pack(
        f"<{itemsize}H", *[len(p) for p in out_planes]
    )
    chunks = ChunkList([directory])
    chunks.crcs = [zlib.crc32(directory)]
    for p in out_planes:
        crcs = resolve_crcs(p)
        if crcs is None:  # raw/rans planes: hash on the chunk pool
            crcs = [
                _pool().submit(zlib.crc32, c) if len(c) >= _CRC_PAR_MIN
                else zlib.crc32(c)
                for c in p
            ]
        chunks.extend(p)
        chunks.crcs.extend(crcs)
    return chunks


def decode_float_stream(chunks: list[bytes]) -> bytes:
    """Inverse of encode_float_stream -> the original (unshuffled) bytes."""
    planes, itemsize = decode_float_planes(chunks)
    shuffled = b"".join(planes)
    if itemsize == 1:
        return shuffled
    return unshuffle_bytes(shuffled, itemsize)


def decode_float_planes(chunks: list[bytes], item_range=None, out=None):
    """Decode a PLC section to its byte planes WITHOUT the join+unshuffle:
    (planes, itemsize). The device-plane decode path uploads these directly
    and reassembles the floats on device (api._combine_planes, or kernel N
    for the AC section). out: a writable (itemsize, items) uint8 array that
    takes plane i in row i (join_into) in place of its join; the planes
    returned are then its rows.

    item_range=(i0, i1): return only items [i0, i1) of each plane,
    touching only the covering chunks (raw planes slice the container
    buffer zero-copy; the joined rANS stream has no random access) — the
    multi-host slice decode's DC/AC path."""
    import struct

    verify_chunk_range(chunks, 0, 1)  # directory chunk
    directory = chunks[0]
    itemsize = directory[0]
    methods = directory[1 : 1 + itemsize]
    (items,) = struct.unpack_from("<I", directory, 1 + itemsize)
    counts = struct.unpack_from(f"<{itemsize}H", directory, 5 + itemsize)
    if out is not None and out.shape[0] != itemsize:
        raise ValueError(f"corrupted container: {itemsize} planes where "
                         f"{out.shape[0]} were expected")
    # submit every plane's chunk decodes before gathering any (cross-plane
    # parallelism, mirror of the encode side); raw planes join zero-copy
    # when their chunks are consecutive views of the container buffer
    exp = getattr(chunks, "expected_crcs", None)
    subs = []
    off = 1
    for i in range(itemsize):
        sub = ChunkList(chunks[off : off + counts[i]])
        if exp is not None:  # slicing drops the attribute — re-attach
            sub.expected_crcs = exp[off : off + counts[i]]
        subs.append(sub)
        off += counts[i]
    if item_range is not None:
        i0, i1 = item_range
        planes = []
        for i, sub in enumerate(subs):
            m = methods[i]
            if m == 0:
                verify_covering_chunks(sub, i0, i1)  # raw: offsets match
                plane = memoryview(join_chunks(sub))[i0:i1]
            elif m == 3:
                plane = decode_chunk_range(sub, i0, i1, zstd_decompress)
            elif m == 1:
                plane = decode_chunk_range(sub, i0, i1, inflate)
            else:
                from .. import native

                verify_chunk_range(sub)  # rANS has no random access
                plane = memoryview(native.rans_decompress(b"".join(sub)))[
                    i0:i1
                ]
            if len(plane) != i1 - i0:
                raise ValueError(
                    f"plane {i} range decodes to {len(plane)} bytes, "
                    f"expected {i1 - i0}"
                )
            planes.append(plane)
        return planes, itemsize
    chunk_futs: list = [None] * itemsize
    single_futs: list = [None] * itemsize
    for i, sub in enumerate(subs):
        verify_chunk_range(sub)  # full decode touches every chunk
        if methods[i] == 3:
            chunk_futs[i] = [_pool().submit(zstd_decompress, c) for c in sub]
        elif methods[i] == 2:
            from .. import native

            single_futs[i] = _pool().submit(
                lambda s=sub: native.rans_decompress(b"".join(s))
            )
        elif methods[i] == 1:
            chunk_futs[i] = [_pool().submit(inflate, c) for c in sub]
    planes = []
    for i, sub in enumerate(subs):
        if chunk_futs[i] is not None:
            pieces = [f.result() for f in chunk_futs[i]]
        elif single_futs[i] is not None:
            pieces = [single_futs[i].result()]
        else:
            pieces = sub
        if out is not None:
            planes.append(join_into(pieces, out[i]))
            continue
        plane = join_chunks(pieces)
        if len(plane) != items:
            raise ValueError(
                f"plane {i} decodes to {len(plane)} bytes, expected {items}"
            )
        planes.append(plane)
    return planes, itemsize


def chunked_deflate(
    data: bytes | memoryview, chunk_bytes: int, level: int = 6, strategy: int = 0
) -> list[bytes]:
    """Split into fixed-size chunks and deflate each independently (v2)."""
    data = memoryview(data)
    chunks = [
        data[off : off + chunk_bytes] for off in range(0, len(data), chunk_bytes)
    ]
    if not chunks:
        return []
    return deflate_streams(chunks, level, strategy)


def chunked_inflate(chunks: Sequence[bytes], out=None):
    """The joined bytes of a chunked deflate section; out as
    chunked_unzstd's."""
    if not chunks:
        return b"" if out is None else join_into((), out)
    verify_chunk_range(chunks)
    pieces = inflate_streams(chunks)
    return b"".join(pieces) if out is None else join_into(pieces, out)
