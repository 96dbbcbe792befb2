"""Public compress / decompress of the PyTorch port (port of dctz_tpu/api.py).

The port runs one slice of the JAX package's configurations, the one its
benchmark measures: float32 input, mode "ec", a v2 container with the
device-packed id stream (ids_codec="device", DPK), verify on or off,
monolithic (no DTZS segments). Everything else raises NotImplementedError
naming the ROADMAP item that will port it; nothing falls back silently.

  compress:   stats (sf, mean) -> tolerance -> kernels A + B
              (ops/dpk_fuse.encode_x_fused; retried at full chunk width on
              exception overflow) -> byte-plane split on the device ->
              host container assembly (_pack_dpk_v2)
  decompress: parse -> host re-pad of the tight sections (_dpk_decode_prep)
              -> planes back to float32 on the device -> kernels C + D

`device` is explicit ("cuda" by default; the CPU tests pass "cpu"). On a
CUDA device every kernel of the path launches; on the CPU each kernel's
plain version runs instead.
"""

from __future__ import annotations

import struct
import warnings
from typing import Any

import numpy as np
import torch

from .config import CodecConfig
from .core import constants as C
from .core import container as ct
from .core import entropy
from .core import quantize as qz

_DPK_META_FMT = "<QHH2x"  # n_stream (padded elements), tile_b, AC chunk width
_DPK_META_SIZE = struct.calcsize(_DPK_META_FMT)
_VERBATIM_CHUNK = 1 << 20  # split stored-verbatim sections for parallel crc
_PAD_QUANTUM = 1024  # the fused encode pads to whole (8, 128) tiles
AUTO_SEGMENT_THRESHOLD = 1 << 25  # dctz_tpu/stream.py AUTO_THRESHOLD


def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to dctz_tpu_torch yet (ROADMAP item {item})"
    )


def _check_slice(cfg: CodecConfig, n: int) -> None:
    """Raise for every configuration outside the ported slice."""
    if cfg.container != "v2":
        raise _todo("the v1 container", "8")
    if cfg.mode != "ec":
        raise _todo("QT mode", "7")
    if cfg.ids_codec != "device":
        raise _todo(f"ids_codec={cfg.ids_codec!r}", "8")
    if cfg.rate != "fixed" or cfg.brsf != 1.0:
        raise _todo("rate='auto' / brsf != 1", "9")
    if cfg.dct_precision != "highest":
        raise _todo("dct_precision='high'", "9")
    if cfg.dc_delta:
        raise _todo("dc_delta on compress", "9")
    if cfg.block_size != C.BLK_SZ or cfg.nbins != C.NBINS or not cfg.truncate:
        raise _todo("non-default block/bin geometry or truncate=False", "9")
    se = cfg.segment_elems
    if (se == "auto" and n >= AUTO_SEGMENT_THRESHOLD) or (
        isinstance(se, int) and se and n >= 2 * se
    ):
        raise _todo("the segmented DTZS pipeline (segment_elems)", "6")


def _zstd_on(cfg: CodecConfig) -> bool:
    return cfg.host_codec == "auto" and entropy.zstd_available()


def _stats_device(x_padded: torch.Tensor, n_real: int, sf_adj: int):
    """(sf, mean) over a zero-padded array (float32 scalars on its device)."""
    from .core.stats import amax_mean, scaling_factor

    amax, mean = amax_mean(x_padded, n_real)
    return scaling_factor(amax, sf_adj), mean


def _plane_split2(dc: torch.Tensor, ac: torch.Tensor):
    """Byte planes of the float32 DC/AC streams on the device: plane k is the
    k-th little-endian byte of each item (entropy.shuffle_bytes' layout)."""

    def split(a):
        u = a.contiguous().view(torch.int32)
        return torch.stack([((u >> (8 * k)) & 255).to(torch.uint8) for k in range(4)])

    return split(dc), split(ac)


def _combine_planes(pl: torch.Tensor) -> torch.Tensor:
    """Inverse of _plane_split2: (4, ...) u8 planes -> float32."""
    u = pl[0].to(torch.int32)
    for k in range(1, pl.shape[0]):
        u = u | (pl[k].to(torch.int32) << (8 * k))
    return u.view(torch.float32)


def _f32_delta_inv_dev(dc: torch.Tensor) -> torch.Tensor:
    """Device twin of entropy.f32_delta_inv (exact u32 arithmetic, carried in
    int64). Item 0 sits on a restart boundary."""
    a = dc.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    n = a.shape[0]
    r = entropy.DC_RESTART
    k = -(-n // r)
    m2 = torch.nn.functional.pad(a, (0, k * r - n)).reshape(k, r)
    m = (torch.cumsum(m2, dim=1) & 0xFFFFFFFF).reshape(-1)[:n]
    u = torch.where((m >> 31) != 0, m & 0x7FFFFFFF, (~m) & 0xFFFFFFFF)
    u = torch.where(u >= (1 << 31), u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def _dcd_on(cfg: CodecConfig, header: ct.Header) -> bool:
    return cfg.dc_delta and cfg.container == "v2" and header.dtype == np.float32


def _float_sections_planes(planes, cfg: CodecConfig, header: ct.Header,
                           dc_delta: bool = False):
    """Section chunks for device-split byte planes (u8 arrays)."""
    header.plc = True
    if dc_delta:
        header.dcd = True
    return entropy.encode_float_planes(
        list(planes), cfg.chunk_bytes, cfg.zlib_level, use_zlib=not _zstd_on(cfg)
    )


def _float_sections(raw: bytes, isz: int, cfg: CodecConfig, header: ct.Header,
                    dc: bool = False) -> list[bytes]:
    """Section chunks for a DC/AC float stream handed over as bytes."""
    if dc and isz == 4 and _dcd_on(cfg, header):
        raw = entropy.f32_delta(np.frombuffer(raw, np.float32)).tobytes()
        header.dcd = True
    if cfg.float_codec == "plane":
        header.plc = True
        return entropy.encode_float_stream(
            raw, isz if cfg.shuffle else 1, cfg.chunk_bytes, cfg.zlib_level,
            use_zlib=not _zstd_on(cfg),
        )
    if cfg.shuffle:
        raw = entropy.shuffle_bytes(raw, isz)
    return entropy.chunked_deflate(raw, cfg.chunk_bytes, cfg.zlib_level)


def _plane_mode(cfg: CodecConfig, dc_dev: torch.Tensor) -> bool:
    """The device plane split applies when the host stage would shuffle a
    float32 stream anyway (the default v2 layout)."""
    return cfg.float_codec == "plane" and cfg.shuffle and dc_dev.dtype == torch.float32


def _dpk_sections(width, packed_rows, exc_rows, exc_counts, ac_counts, tile_b,
                  cw, n_stream, cfg, header):
    """Host assembly of the 4 DPK id sections (width, packed, exceptions,
    meta) and their container flags; a copy of dctz_tpu.api._dpk_sections."""
    import zlib

    from . import native
    from .ops import idpack

    header.dpk = True
    zs = _zstd_on(cfg)
    header.dpks = cfg.dpk_host_codec == "zstd" and entropy.zstd_available()
    header.dpkz = cfg.dpk_host_codec == "deflate"
    header.dpkr = cfg.dpk_host_codec == "rans" and native.available()
    width = np.asarray(width)
    packed_rows = np.asarray(packed_rows)
    exc_rows = np.asarray(exc_rows)
    exc_counts = np.asarray(exc_counts)
    lvl = cfg.ids_zlib_level or cfg.zlib_level
    header.zst = cfg.ids_zlib_level is None and zs
    header.rans = (
        not header.zst
        and cfg.ids_zlib_level is None
        and int(exc_counts.sum()) >= (1 << 18)
        and native.available()
    )

    def _packed_task():
        bpr = idpack.packed_nbytes(width.reshape(-1), tile_b)
        tight = entropy.take_row_prefixes(packed_rows, bpr)
        if header.dpks:
            return entropy.chunked_zstd(tight.tobytes(), cfg.chunk_bytes, 1)
        if header.dpkz:
            return entropy.chunked_deflate(tight.tobytes(), cfg.chunk_bytes, 1)
        if header.dpkr:
            return [native.rans_compress(tight)]
        # stored verbatim: zero-copy views, split only so the container
        # crc32s run in parallel on the pool
        t_view = memoryview(tight)
        out = entropy.ChunkList(
            [t_view]
            if len(t_view) <= _VERBATIM_CHUNK
            else [t_view[i : i + _VERBATIM_CHUNK]
                  for i in range(0, len(t_view), _VERBATIM_CHUNK)]
        )
        out.crcs = [entropy._pool().submit(zlib.crc32, c) for c in out]
        return out

    def _exc_task():
        exc_tight = entropy.take_row_prefixes(exc_rows, exc_counts)
        if header.zst:
            return entropy.chunked_zstd(memoryview(exc_tight), cfg.chunk_bytes, 1)
        if header.rans:
            return [native.rans_compress(exc_tight)]
        return entropy.chunked_deflate(
            memoryview(exc_tight), cfg.chunk_bytes, min(lvl, 3)
        )

    def _side_sec(data) -> list[bytes]:
        if header.zst:
            return entropy.chunked_zstd(data, cfg.chunk_bytes, 1)
        sl = min(lvl, 1) if len(data) >= (1 << 17) else lvl
        return entropy.chunked_deflate(data, cfg.chunk_bytes, sl)

    def _meta_task():
        meta = (
            struct.pack(_DPK_META_FMT, n_stream, tile_b, cw)
            + exc_counts.astype(np.uint16).tobytes()
            + np.asarray(ac_counts, np.uint16).tobytes()
        )
        return _side_sec(meta)

    pool = entropy.section_pool()
    f_packed = pool.submit(_packed_task)
    f_exc = pool.submit(_exc_task)
    f_meta = pool.submit(_meta_task)
    width_sec = _side_sec(width.tobytes())
    return (width_sec, f_packed.result(), f_exc.result(), f_meta.result())


def _pack_dpk_v2(header, width, packed_rows, exc_rows, exc_counts, counts,
                 ac_chunks, dc, n_pad, cfg, *, dc_planes=None, ac_planes=None):
    """Host assembly of a DPK v2 container from the device outputs (numpy);
    dc_planes/ac_planes are the device-split byte planes replacing dc and
    ac_chunks (the same bytes, no host shuffle)."""
    from .ops import idpack

    header.shuffle = cfg.shuffle
    pool = entropy.section_pool()

    def _ac_task():
        if ac_planes is not None:
            k, nch, capc = ac_planes.shape
            flat = entropy.take_row_prefixes(
                ac_planes.reshape(k * nch, capc), np.tile(counts, k)
            )
            per = flat.size // k
            return _float_sections_planes(
                [flat[i * per : (i + 1) * per] for i in range(k)], cfg, header
            )
        ac = entropy.take_row_prefixes(ac_chunks, counts)
        return _float_sections(ac.tobytes(), ac.dtype.itemsize, cfg, header)

    if dc_planes is not None:
        f_dc = pool.submit(_float_sections_planes, list(dc_planes), cfg, header,
                           _dcd_on(cfg, header))
    else:
        f_dc = pool.submit(_float_sections, dc.tobytes(), dc.dtype.itemsize,
                           cfg, header, True)
    f_ac = pool.submit(_ac_task)
    streams = _dpk_sections(
        width, packed_rows, exc_rows, exc_counts, counts, idpack.B_DEFAULT,
        qz.chunk_width(n_pad, cfg.block_size), n_pad, cfg, header,
    ) + (f_dc.result(), f_ac.result())
    return ct.pack_v2(header, streams, None, cfg.chunk_bytes)


def _resolve_input(x, device) -> torch.Tensor:
    """A flat float32 tensor on `device` (float64 is not ported yet)."""
    if isinstance(x, torch.Tensor):
        arr = x
    else:
        a = np.asarray(x)
        if a.dtype == np.float64:
            raise _todo("float64 input", "9")
        if a.dtype != np.float32:
            raise TypeError(f"unsupported dtype {a.dtype}; use float32")
        arr = torch.from_numpy(np.ascontiguousarray(a))
    if arr.dtype == torch.float64:
        raise _todo("float64 input", "9")
    if arr.dtype != torch.float32:
        raise TypeError(f"unsupported dtype {arr.dtype}; use float32")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
    return arr.reshape(-1).to(device)


def compress(
    x: Any,
    *,
    config: CodecConfig,
    timer=None,
    device: str | torch.device = "cuda",
) -> bytes:
    """Compress a flat float32 array (numpy or torch) into a DPK v2 container.

    Unlike dctz_tpu.compress, `config` is required and must select the
    ported slice (container="v2", ids_codec="device", mode="ec")."""
    from .utils.timing import StageTimer

    timer = timer or StageTimer()
    cfg = config
    with timer.stage("transfer"):
        arr = _resolve_input(x, device)
    n = int(arr.shape[0])
    if n == 0:
        raise ValueError("cannot compress an empty array")
    _check_slice(cfg, n)
    if cfg.internal_dtype not in ("auto", "float32"):
        raise ValueError(f"internal_dtype {cfg.internal_dtype!r}")
    return _compress_fused(arr, n, cfg, timer)


def _compress_fused(arr: torch.Tensor, n: int, cfg: CodecConfig, timer) -> bytes:
    """The DPK EC branch of dctz_tpu.api._compress_fused: pad to the tile
    quantum, stats, kernels A + B (retried at full chunk width on exception
    overflow), byte planes to the host, container assembly."""
    from .ops import idpack
    from .ops.fused_encode import fused_encode_pipeline_dpk_ec

    pad = (-n) % _PAD_QUANTUM
    with timer.stage("device"):
        if pad:
            arr = torch.nn.functional.pad(arr, (0, pad))
        n_pad = n + pad
        sf, mean = _stats_device(arr, n, cfg.sf_adj)
        cw = qz.chunk_width(n_pad, cfg.block_size)
        uout = fused_encode_pipeline_dpk_ec(
            arr, sf, cfg.error_bound, idpack.CAPE, n, cfg.verify
        )
        if bool(uout[7]):
            # exception-capacity overflow: retry at full chunk width
            uout = fused_encode_pipeline_dpk_ec(
                arr, sf, cfg.error_bound, cw, n, cfg.verify
            )
        width, packed_rows, exc_rows, exc_counts, ac_chunks, counts, dc = uout[:7]
        bound_ok = uout[8] if cfg.verify else None
    if bound_ok is not None and not bool(bound_ok):
        warnings.warn(
            "verify-repair could not fully satisfy the pointwise bound "
            "(float32-truncation floor)",
            stacklevel=3,
        )
    with timer.stage("transfer"):
        host = lambda t: t.cpu().numpy()  # noqa: E731
        dc_planes = ac_planes = None
        if _plane_mode(cfg, dc):
            dcp, acp = _plane_split2(dc, ac_chunks)
            dc_planes, ac_planes = host(dcp), host(acp)
        else:
            dc, ac_chunks = host(dc), host(ac_chunks)
        width, packed_rows, exc_rows, exc_counts, counts = map(
            host, (width, packed_rows, exc_rows, exc_counts, counts)
        )
        sf, mean = float(sf), float(mean)
    header = ct.Header(
        dtype=np.dtype(np.float32),
        num_elements=n,
        error_bound=cfg.error_bound,
        ac_count=int(counts.sum()),
        scaling_factor=sf,
        mean=mean,
        bindex_nbytes=0,
        dc_nbytes=0,
        ac_nbytes=0,
        mode=cfg.mode,
        block_size=cfg.block_size,
        nbins=cfg.nbins,
        truncate=cfg.truncate,
        brsf=cfg.brsf,
    )
    with timer.stage("zlib"):
        return _pack_dpk_v2(
            header, width, packed_rows, exc_rows, exc_counts, counts,
            None if ac_planes is not None else ac_chunks,
            None if dc_planes is not None else dc, n_pad, cfg,
            dc_planes=dc_planes, ac_planes=ac_planes,
        )


def _header_config(header: ct.Header) -> CodecConfig:
    return CodecConfig(
        mode=header.mode,
        error_bound=header.error_bound,
        truncate=header.truncate,
        block_size=header.block_size,
        nbins=header.nbins,
        brsf=header.brsf,
    )


def _float_raw(header: ct.Header, chunks, planes_ok: bool):
    """A DC/AC section's bytes, or ("planes", [plane bytes]) for a 4-byte-item
    PLC section (the device reassembles those, _combine_planes)."""
    if planes_ok and header.plc:
        planes, itemsize = entropy.decode_float_planes(chunks)
        if itemsize == 4:
            return ("planes", planes)
        shuffled = b"".join(planes)
        if itemsize == 1:
            return shuffled
        return entropy.unshuffle_bytes(shuffled, itemsize)
    if header.plc:
        raw = entropy.decode_float_stream(chunks)
    else:
        raw = entropy.chunked_inflate(chunks)
        if header.shuffle:
            raw = entropy.unshuffle_bytes(raw, header.stored_dtype.itemsize)
    return raw


def _dpk_host_rebuild(header: ct.Header, streams):
    """Re-inflate a DPK container's side streams and re-pad the tight layouts
    into fixed-capacity rows. Returns (width (T,bs), rows, exc_rows, dc_raw,
    ac_raw, n_stream, tile_b, cw, ac_counts, nblk)."""
    from . import native
    from .ops import idpack

    widths_z, packed_raw, exc_z, meta_z, dz, az = streams
    pool = entropy.section_pool()
    _side = entropy.chunked_unzstd if header.zst else entropy.chunked_inflate

    def _tight_task():
        if header.dpks:
            return entropy.chunked_unzstd(packed_raw)
        if header.dpkz:
            return entropy.chunked_inflate(packed_raw)
        entropy.verify_chunk_range(packed_raw)
        if header.dpkr:
            return native.rans_decompress(entropy.join_chunks(packed_raw))
        return entropy.join_chunks(packed_raw)

    def _exc_task():
        if header.zst:
            return entropy.chunked_unzstd(exc_z)
        if header.rans:
            entropy.verify_chunk_range(exc_z)
            return native.rans_decompress(b"".join(exc_z))
        return entropy.chunked_inflate(exc_z)

    f_width = pool.submit(_side, widths_z)
    f_tight = pool.submit(_tight_task)
    f_exc = pool.submit(_exc_task)
    f_dc = pool.submit(_float_raw, header, dz, True)
    f_ac = pool.submit(_float_raw, header, az, True)

    meta = _side(meta_z)
    n_stream, tile_b, cw = struct.unpack_from(_DPK_META_FMT, meta, 0)
    bs = header.block_size
    nblk = -(-n_stream // bs)
    t = idpack.tiles_of(nblk, tile_b)
    n_chunks = (nblk * bs) // cw
    off = _DPK_META_SIZE
    exc_counts = np.frombuffer(meta, np.uint16, n_chunks, off).astype(np.int64)
    ac_counts = np.frombuffer(
        meta, np.uint16, n_chunks, off + 2 * n_chunks
    ).astype(np.int64)

    width = np.frombuffer(f_width.result(), np.uint8, bs * t).reshape(t, bs)
    bpr = idpack.packed_nbytes(width.reshape(-1), tile_b)
    f_rows = pool.submit(
        lambda: entropy.pad_row_prefixes(f_tight.result(), bpr, tile_b // 2, np.uint8)
    )
    exc_tight = np.frombuffer(f_exc.result(), np.uint8)
    peak_e = int(exc_counts.max()) if exc_counts.size else 0
    cape = next(
        c for c in [c for c in (32, 64, 128, 256) if c < cw] + [cw]
        if c >= min(peak_e, cw)
    )
    exc_rows = entropy.pad_row_prefixes(exc_tight, exc_counts, cape, np.uint8)
    return (width, f_rows.result(), exc_rows, f_dc.result(), f_ac.result(),
            n_stream, tile_b, cw, ac_counts, nblk)


def _capc_tier(peak: int, cw: int) -> int:
    """Smallest AC row-capacity tier covering the per-chunk peak."""
    tiers = [tt for tt in (32, 64, 128) if tt < cw] + [cw]
    return next(tt for tt in tiers if tt >= min(peak, cw))


def _stored_dtype(header: ct.Header, dc_nbytes: int, nblk: int):
    """The stored float dtype from the DC section length (float32 unless the
    container was written with truncate=False)."""
    if dc_nbytes == nblk * header.dtype.itemsize and header.dtype != np.float32:
        return header.dtype
    return np.dtype(np.float32)


def _dpk_decode_prep(header: ct.Header, streams):
    """Host stage of DPK decompress: ((width, packed_rows, exc_rows, dc, ac)
    numpy arrays, (n_stream, tile_b, cw, cfg)). dc is (4, nblk) byte planes
    or float32 (nblk,); ac is (4, nc, capc) planes or float32 (nc, capc)."""
    (width, rows, exc_rows, dc_raw, ac_raw, n_stream, tile_b, cw, ac_counts,
     nblk) = _dpk_host_rebuild(header, streams)
    cfg = _header_config(header)
    dc_pl = isinstance(dc_raw, tuple)
    ac_pl = isinstance(ac_raw, tuple)
    if not dc_pl and _stored_dtype(header, len(dc_raw), nblk) != np.float32:
        raise _todo("full-width (truncate=False) float64 streams", "9")
    if dc_pl:
        dc = np.stack([np.frombuffer(p, np.uint8, nblk) for p in dc_raw[1]])
    else:
        dc = np.frombuffer(dc_raw, dtype=np.float32, count=nblk)
    capc = _capc_tier(int(ac_counts.max()) if ac_counts.size else 0, cw)
    if ac_pl:
        pls = [np.frombuffer(p, np.uint8, header.ac_count) for p in ac_raw[1]]
        ac = entropy.pad_row_prefixes(
            np.concatenate(pls), np.tile(ac_counts, len(pls)), capc, np.uint8
        ).reshape(len(pls), ac_counts.size, capc)
    else:
        ac = np.frombuffer(ac_raw, dtype=np.float32, count=header.ac_count)
        ac = entropy.pad_row_prefixes(ac, ac_counts, capc, np.float32)
    return (width, rows, exc_rows, dc, ac), (n_stream, tile_b, cw, cfg)


def _decode_device_dpk(width, packed_rows, exc_rows, dc, ac_buf, n: int,
                       cfg: CodecConfig, tile_b: int, cw: int, sf, dcd: bool):
    """Kernels C + D (ops/dpk_fuse.decode_fused) on the device arrays of a
    DPK container -> (n,) float32. dc/ac_buf may arrive as (4, ...) u8 byte
    planes, reassembled here."""
    from .ops import dpk_fuse

    if tile_b != dpk_fuse.TILE_B:
        raise _todo(f"DPK tile_b={tile_b}", "9")
    if dc.dtype == torch.uint8:
        dc = _combine_planes(dc)
    if ac_buf.dtype == torch.uint8:
        ac_buf = _combine_planes(ac_buf)
    if dcd:
        dc = _f32_delta_inv_dev(dc)
    return dpk_fuse.decode_fused(width, packed_rows, exc_rows,
                                 ac_buf.contiguous(), dc.contiguous(), sf, cfg,
                                 cw, n)


def _decompress_dpk(header: ct.Header, streams, timer, device) -> np.ndarray:
    with timer.stage("host"):
        (width, rows, exc_rows, dc, ac), (n_stream, tile_b, cw, cfg) = (
            _dpk_decode_prep(header, streams)
        )
        n = header.num_elements
    with timer.stage("transfer"):
        dev = [torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device)
               for a in (width, rows, exc_rows, dc, ac)]
        sf = torch.tensor(header.scaling_factor, dtype=torch.float32, device=device)
    with timer.stage("device"):
        x = _decode_device_dpk(*dev, n_stream, cfg, tile_b, cw, sf, header.dcd)
    with timer.stage("transfer"):
        out = x.cpu().numpy()
    return out[:n]


def decompress(blob: bytes | memoryview, *, timer=None,
               device: str | torch.device = "cuda") -> np.ndarray:
    """Decompress a DPK EC v2 container back to a flat float32 numpy array."""
    from .utils.timing import StageTimer

    timer = timer or StageTimer()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
    if bytes(memoryview(blob)[:4]) == b"DTZS":
        raise _todo("the segmented DTZS stream container", "6")
    if ct.detect_format(blob) != "v2":
        raise _todo("the v1 container", "8")
    with timer.stage("host"):
        header, streams, qtable, _cb = ct.parse_v2(blob)
    if not header.dpk:
        raise _todo("v2 containers without the DPK id stream", "8")
    if header.mode != "ec" or qtable is not None:
        raise _todo("QT mode", "7")
    if header.dtype != np.float32:
        raise _todo("float64 containers", "9")
    return _decompress_dpk(header, streams, timer, device)

