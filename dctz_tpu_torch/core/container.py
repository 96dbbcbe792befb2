"""Container formats (v1 reference layout, v2 chunked layout).

A numpy-only copy of dctz_tpu/core/container.py: importing the JAX
package would load jax, so the port carries its own copy. The byte layout is
the same; dctz_tpu/core/container.py documents it.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from . import constants as C

_DT_FLOAT = 0
_DT_DOUBLE = 1

_V1_HEADER_FMT = "<iIdI4xdd III I"
V1_HEADER_SIZE = struct.calcsize(_V1_HEADER_FMT)
assert V1_HEADER_SIZE == 56

V2_MAGIC = b"DTZ2"


@dataclasses.dataclass
class Header:
    """Parsed container metadata (both formats)."""

    dtype: np.dtype  # element dtype of the original array
    num_elements: int
    error_bound: float
    ac_count: int
    scaling_factor: float
    mean: float
    bindex_nbytes: int  # compressed
    dc_nbytes: int  # compressed
    ac_nbytes: int  # compressed
    mode: str  # "ec" | "qt"
    block_size: int = C.BLK_SZ
    nbins: int = C.NBINS
    truncate: bool = True
    shuffle: bool = False  # v2: DC/AC streams byte-shuffled before deflate
    ids4: bool = False  # v2: bin-index stream nibble-packed + exception stream
    rans: bool = False  # v2: ids sections rANS-coded (native codec)
    dpk: bool = False  # v2: bin-index stream device-packed (ops/idpack.py)
    dpkz: bool = False  # v2: DPK packed section host-deflated (ratio mode)
    dpkr: bool = False  # v2: DPK packed section host-rANS-coded (fast ratio mode)
    plc: bool = False  # v2: DC/AC sections per-plane coded (entropy.encode_float_stream)
    zst: bool = False  # v2: side sections (ids4 exc / DPK width, exc, meta) chunk-zstd
    dpks: bool = False  # v2: DPK packed section host-zstd-coded (fast ratio mode)
    dcd: bool = False
    #: bin-range scaling factor (reference compile-time BRSF, dctz.h:29).
    #: v2 records it in the reserved byte (0 = 1.0, else 2**((code-128)/8))
    #: — without it a brsf != 1 container would silently decode with the
    #: wrong bin geometry. v1 cannot represent it (fixed reference layout).
    brsf: float = 1.0

    @property
    def nblk(self) -> int:
        return -(-self.num_elements // self.block_size)

    @property
    def stored_dtype(self) -> np.dtype:
        """dtype of the DC / AC_exact streams (USE_TRUNCATE => float32)."""
        return np.dtype(np.float32) if self.truncate else self.dtype


def _union_bytes(value: float, dtype: np.dtype) -> bytes:
    """8-byte union holding a double, or a float in the low 4 bytes."""
    if dtype == np.float64:
        return struct.pack("<d", float(value))
    return struct.pack("<f4x", float(value))


def _union_value(raw: bytes, dtype: np.dtype) -> float:
    if dtype == np.float64:
        return struct.unpack("<d", raw)[0]
    return struct.unpack("<f4x", raw)[0]


def pack_v1(
    header: Header,
    bindex_z: bytes,
    dc_z: bytes,
    ac_z: bytes,
    qtable: np.ndarray | None,
) -> bytes:
    """Assemble the reference container (dctz-comp-lib.c:775-820)."""
    dt_tag = _DT_DOUBLE if header.dtype == np.float64 else _DT_FLOAT
    tail_field = header.num_elements if header.mode == "qt" else 0
    hdr = struct.pack(
        "<iIdI4x",
        dt_tag,
        header.num_elements,
        header.error_bound,
        header.ac_count,
    )
    hdr += _union_bytes(header.scaling_factor, header.dtype)
    hdr += _union_bytes(header.mean, header.dtype)
    hdr += struct.pack(
        "<IIII", len(bindex_z), len(dc_z), len(ac_z), tail_field
    )
    assert len(hdr) == V1_HEADER_SIZE
    parts = [hdr, bindex_z, dc_z, ac_z]
    if header.mode == "qt":
        if qtable is None:
            raise ValueError("QT container requires a qtable")
        parts.append(np.ascontiguousarray(qtable, dtype=header.dtype).tobytes())
    return b"".join(parts)


def parse_v1(blob: bytes | memoryview) -> tuple[Header, bytes, bytes, bytes, np.ndarray | None]:
    """Split a v1 container into (header, bindex_z, dc_z, ac_z, qtable).

    Mode is inferred structurally: QT files carry block_size raw qtable
    entries after the third stream (the reference distinguishes by binary /
    file suffix instead, dctz-test.c:99-103).
    """
    blob = memoryview(blob)
    if len(blob) < V1_HEADER_SIZE:
        raise ValueError(
            f"truncated container: {len(blob)} bytes < {V1_HEADER_SIZE} header"
        )
    (dt_tag, n, eb, ac_count) = struct.unpack_from("<iIdI4x", blob, 0)
    dtype = np.dtype(np.float64 if dt_tag == _DT_DOUBLE else np.float32)
    sf = _union_value(bytes(blob[24:32]), dtype)
    mean = _union_value(bytes(blob[32:40]), dtype)
    b_sz, d_sz, a_sz, _tail = struct.unpack_from("<IIII", blob, 40)

    body_end = V1_HEADER_SIZE + b_sz + d_sz + a_sz
    qtable_bytes = C.BLK_SZ * dtype.itemsize
    if len(blob) == body_end + qtable_bytes:
        mode = "qt"
    elif len(blob) >= body_end:
        mode = "ec"
    else:
        raise ValueError(
            f"truncated container: {len(blob)} bytes < {body_end} expected"
        )

    header = Header(
        dtype=dtype,
        num_elements=n,
        error_bound=eb,
        ac_count=ac_count,
        scaling_factor=sf,
        mean=mean,
        bindex_nbytes=b_sz,
        dc_nbytes=d_sz,
        ac_nbytes=a_sz,
        mode=mode,
    )
    off = V1_HEADER_SIZE
    bindex_z = bytes(blob[off : off + b_sz])
    off += b_sz
    dc_z = bytes(blob[off : off + d_sz])
    off += d_sz
    ac_z = bytes(blob[off : off + a_sz])
    off += a_sz
    qtable = None
    if mode == "qt":
        qtable = np.frombuffer(
            bytes(blob[off : off + qtable_bytes]), dtype=dtype
        ).copy()
    return header, bindex_z, dc_z, ac_z, qtable



_V2_FIXED_FMT = "<4sHHQdddQHHBxI"  # through chunk_bytes
_V2_FIXED_SIZE = struct.calcsize(_V2_FIXED_FMT)

_FLAG_QT = 1 << 0
_FLAG_TRUNCATE = 1 << 1
_FLAG_F64 = 1 << 2
_FLAG_SHUFFLE = 1 << 3  # DC/AC streams byte-shuffled before deflate
_FLAG_IDS4 = 1 << 4  # bin-index stream nibble-packed (4th section = exceptions)
_FLAG_RANS = 1 << 5  # ids sections use the native rANS codec, not deflate
# bin-index stream device-packed (ops/idpack.py): 6 sections
# (widths, packed-raw, exceptions, meta, dc, ac) — the packed section is
# stored verbatim (it is already entropy-coded on the device)
_FLAG_DPK = 1 << 6
# the DPK packed section additionally deflated on the host (ratio mode)
_FLAG_DPKZ = 1 << 7
_FLAG_DPKR = 1 << 9
# DC/AC sections use the per-plane float codec (entropy.encode_float_stream):
# each byte plane of the shuffled stream carries its own method (raw planes
# skip deflate entirely — the low mantissa planes are near-random)
_FLAG_PLC = 1 << 8
# side sections that would be chunk-deflated are chunk-zstd-coded instead
# (ids4 exceptions; DPK width / exceptions / meta) — entropy.chunked_zstd
_FLAG_ZST = 1 << 10
_FLAG_DPKS = 1 << 11
# DC section delta-coded (Header.dcd)
_FLAG_DCD = 1 << 12



def brsf_code(brsf: float) -> int:
    """Header byte for the bin-range scaling factor: 0 = 1.0 (legacy and
    default, byte-stable with old containers), else 128 + 8*log2(brsf) —
    an exactly-representable grid the caller must quantize to
    (api._quantize_brsf)."""
    import math

    if brsf == 1.0:
        return 0
    code = round(math.log2(brsf) * 8.0) + 128
    if not 1 <= code <= 255 or 2.0 ** ((code - 128) / 8.0) != brsf:
        raise ValueError(
            f"brsf {brsf} is not representable in the container header; "
            "use api._quantize_brsf's grid (2**(k/8))"
        )
    return code


def brsf_of_code(code: int) -> float:
    return 1.0 if code == 0 else 2.0 ** ((code - 128) / 8.0)


def pack_v2(
    header: Header,
    streams_z: tuple,
    qtable: np.ndarray | None,
    chunk_bytes: int,
) -> bytes:
    """Assemble the chunked container: fixed header, per-stream chunk-count
    + chunk-size tables, chunk payloads, optional raw qtable.

    streams_z: (bindex, dc, ac) chunk lists — plus a 4th (ids exceptions)
    section when header.ids4 is set."""
    flags = 0
    if header.mode == "qt":
        flags |= _FLAG_QT
    if header.truncate:
        flags |= _FLAG_TRUNCATE
    if header.dtype == np.float64:
        flags |= _FLAG_F64
    if header.shuffle:
        flags |= _FLAG_SHUFFLE
    if header.ids4:
        flags |= _FLAG_IDS4
        if len(streams_z) != 4:
            raise ValueError("ids4 container needs 4 stream sections")
    if header.rans:
        flags |= _FLAG_RANS
    if header.dpk:
        flags |= _FLAG_DPK
        if len(streams_z) != 6:
            raise ValueError("dpk container needs 6 stream sections")
    if header.dpkz:
        flags |= _FLAG_DPKZ
    if header.dpkr:
        flags |= _FLAG_DPKR
    if header.plc:
        flags |= _FLAG_PLC
    if header.zst:
        flags |= _FLAG_ZST
    if header.dpks:
        flags |= _FLAG_DPKS
    if header.dcd:
        flags |= _FLAG_DCD
    fixed = struct.pack(
        _V2_FIXED_FMT,
        V2_MAGIC,
        3,  # version 2 = per-chunk crc32 tables; 3 = + header/table crc
        flags,
        header.num_elements,
        header.error_bound,
        header.scaling_factor,
        header.mean,
        header.ac_count,
        header.nbins,
        header.block_size,
        brsf_code(header.brsf),  # 0 keeps brsf=1.0 containers byte-stable
        chunk_bytes,
    )
    import zlib

    from . import entropy

    parts = [fixed]
    for chunks in streams_z:
        parts.append(struct.pack("<I", len(chunks)))
        parts.append(struct.pack(f"<{len(chunks)}I", *[len(c) for c in chunks]))
        # producer-attached crcs (entropy.ChunkList) skip the hash pass here
        crcs = entropy.resolve_crcs(chunks) or entropy.crc32_many(chunks)
        parts.append(struct.pack(f"<{len(chunks)}I", *crcs))
    # version 3: crc over the fixed header + chunk tables — a flipped
    # metadata byte (sf, eb, flags, a chunk size) fails loudly instead of
    # silently decoding garbage (payload chunks carry their own crcs)
    parts.append(
        struct.pack("<I", zlib.crc32(b"".join(parts)) & 0xFFFFFFFF)
    )
    for chunks in streams_z:
        parts.extend(chunks)
    if header.mode == "qt":
        if qtable is None:
            raise ValueError("QT container requires a qtable")
        parts.append(np.ascontiguousarray(qtable, dtype=header.dtype).tobytes())
    return b"".join(parts)


def parse_v2(
    blob: bytes | memoryview,
    chunk_crcs: str = "verify",
) -> tuple[Header, tuple[list[bytes], list[bytes], list[bytes]], np.ndarray | None, int]:
    """Inverse of pack_v2; returns (header, stream chunks, qtable, chunk_bytes).

    chunk_crcs: "verify" (default) sweeps every payload chunk's crc32 up
    front — O(container). "defer" skips the sweep and attaches the stored
    crcs to each section's chunk list (entropy.ChunkList.expected_crcs);
    the decode helpers then verify exactly the chunks they touch
    (entropy.verify_chunk_range) — the multi-host tile-range decode does
    O(range) crc work per host. The header/table crc (version 3) is always
    checked; it covers the crc tables themselves."""
    if chunk_crcs not in ("verify", "defer"):
        raise ValueError(f"chunk_crcs must be verify|defer, got {chunk_crcs}")
    blob = memoryview(blob)
    (
        magic,
        version,
        flags,
        n,
        eb,
        sf,
        mean,
        ac_count,
        nbins,
        block_size,
        _res,
        chunk_bytes,
    ) = struct.unpack_from(_V2_FIXED_FMT, blob, 0)
    if magic != V2_MAGIC:
        raise ValueError("not a v2 container")
    if version not in (1, 2, 3):
        raise ValueError(f"unsupported v2 container version {version}")
    dtype = np.dtype(np.float64 if flags & _FLAG_F64 else np.float32)
    mode = "qt" if flags & _FLAG_QT else "ec"
    if flags & _FLAG_DPK:
        nsections = 6
    elif flags & _FLAG_IDS4:
        nsections = 4
    else:
        nsections = 3

    import zlib

    off = _V2_FIXED_SIZE
    tables: list[list[int]] = []
    crcs: list[list[int]] = []
    for _ in range(nsections):
        (count,) = struct.unpack_from("<I", blob, off)
        off += 4
        sizes = list(struct.unpack_from(f"<{count}I", blob, off))
        off += 4 * count
        tables.append(sizes)
        if version >= 2:
            crcs.append(list(struct.unpack_from(f"<{count}I", blob, off)))
            off += 4 * count
    if version >= 3:
        (hdr_crc,) = struct.unpack_from("<I", blob, off)
        if (zlib.crc32(blob[:off]) & 0xFFFFFFFF) != hdr_crc:
            raise ValueError(
                "corrupted container: header/table crc mismatch"
            )
        off += 4
    from . import entropy

    streams: list[list[memoryview]] = []
    flat: list[memoryview] = []  # all chunks in order, for the parallel crc
    for si, sizes in enumerate(tables):
        chunks = entropy.ChunkList()
        for sz in sizes:
            if off + sz > len(blob):
                raise ValueError("truncated container: chunk past end")
            chunks.append(blob[off : off + sz])
            off += sz
        if version >= 2 and chunk_crcs == "defer":
            chunks.expected_crcs = crcs[si]
        flat.extend(chunks)
        streams.append(chunks)
    if version >= 2 and chunk_crcs == "verify":
        got = entropy.crc32_many(flat)
        want = [c for sec in crcs for c in sec]
        if got != want:
            bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
            si = 0
            while bad >= len(tables[si]):
                bad -= len(tables[si])
                si += 1
            raise ValueError(
                f"corrupted container: crc mismatch in section {si} "
                f"chunk {bad}"
            )
    qtable = None
    if mode == "qt":
        qtable_bytes = block_size * dtype.itemsize
        qtable = np.frombuffer(
            bytes(blob[off : off + qtable_bytes]), dtype=dtype
        ).copy()
        off += qtable_bytes

    dpk = bool(flags & _FLAG_DPK)
    header = Header(
        dtype=dtype,
        num_elements=n,
        error_bound=eb,
        ac_count=ac_count,
        scaling_factor=sf,
        mean=mean,
        bindex_nbytes=sum(sum(t) for t in tables[:-2]) if dpk else sum(tables[0]),
        dc_nbytes=sum(tables[-2]) if dpk else sum(tables[1]),
        ac_nbytes=sum(tables[-1]) if dpk else sum(tables[2]),
        mode=mode,
        block_size=block_size,
        nbins=nbins,
        truncate=bool(flags & _FLAG_TRUNCATE),
        shuffle=bool(flags & _FLAG_SHUFFLE),
        ids4=bool(flags & _FLAG_IDS4),
        rans=bool(flags & _FLAG_RANS),
        dpk=dpk,
        dpkz=bool(flags & _FLAG_DPKZ),
        dpkr=bool(flags & _FLAG_DPKR),
        plc=bool(flags & _FLAG_PLC),
        zst=bool(flags & _FLAG_ZST),
        dpks=bool(flags & _FLAG_DPKS),
        dcd=bool(flags & _FLAG_DCD),
        brsf=brsf_of_code(_res),
    )
    return header, tuple(streams), qtable, chunk_bytes


def detect_format(blob: bytes | memoryview) -> str:
    """'v2' if the magic matches, else 'v1'."""
    return "v2" if bytes(memoryview(blob)[:4]) == V2_MAGIC else "v1"
