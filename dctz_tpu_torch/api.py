"""Public compress / decompress of the PyTorch port (port of dctz_tpu/api.py).

The port runs float32 and float64 input, mode "ec" or "qt", verify on or
off, in three container families, and every other option of CodecConfig
(below). Float32 at the default geometry (blocks of 64, 255 bins, brsf 1,
truncate on) is dispatched as the JAX package dispatches on its TPU:

  DPK v2 (ids_codec="device", what "auto" means for v2), monolithic or
    segmented into a DTZS stream (segment_elems; the default "auto" segments
    arrays of stream.AUTO_THRESHOLD elements or more):
      compress:   stats -> tolerance -> [QT: kernel E] -> kernels A + B
                  (retried at full chunk width on exception overflow) ->
                  [dc_delta: the DC delta] -> byte planes on the device ->
                  host assembly (_dpk_v2_streams); the monolithic container is
                  the stream writer's one-segment case
      decompress: parse -> inflate into one upload buffer, no re-pad
                  (_dpk_decode_prep) -> kernel N (the fixed-capacity rows)
                  -> kernels C + D
  v1, the reference's own format and the default (CodecConfig() and
    compress(x) with no config), and host-coded v2 (ids_codec "deflate" or
    "rans"), monolithic or segmented (DTZS frames of the generic chain,
    stream._encode_segment, which are host-coded v2 containers whatever the
    config's container):
      compress, fused branch (v2 always, v1 when n % 1024 == 0;
                  _fused_eligible): pad to 1024 -> stats -> [QT: kernel E]
                  -> kernel F or G -> [verify: _repair_fused, torch ops]
                  -> kernel H (full chunk width on overflow) -> host
                  streams (deflate, ids4/rANS for v2) -> container
      compress, generic chain (v1 with n % 1024 != 0, and every host-coded
                  DTZS frame): stats -> DCT with a rem-point tail -> bins
                  (QT: column-max qtable) -> [verify] -> kernel H; the
                  transform, bins and repair are torch ops on the device in
                  full float32, as dctz_tpu leaves them to XLA
                  (stream._encode_segment)
      decompress: parse -> inflate -> DC marks on a partial last block ->
                  per-chunk AC counts from the ids -> rows -> kernel I ->
                  kernel D (rem-point tail in-kernel) -> the first n samples

Float64 runs as the JAX package runs it with x64 on and a backend that is
not a TPU (its CPU and GPU policy, and its byte parity with the C codec's
double build): at full width, on the generic chain, since the fused
kernels take float32 alone (dctz_tpu/api.py:269-305). v1 and host-coded v2
write the generic chain's container (for v1 the float64 parity path); DPK
v2 takes the XLA chain's DPK route (dctz_tpu/api.py:1870-1960): the generic
chain, then kernel B (kernel J at other chunk widths that are multiples
of 128, torch ops elsewhere) on the float32 stored values, the id stream
of the TRUE length n; a DTZS stream
writes host-coded v2 frames of the generic chain. The decode moves the
float32 stored values on kernel C (DPK) or I (the others) where their
chunk width holds, torch ops elsewhere, then
dequantizes and runs the inverse transform in float64 torch ops, as the
reference's XLA decode does, and returns float64. internal_dtype="float32"
casts float64 input to float32 and runs the float32 routes, the header
still declaring float64 (its segmented stream declares float32 frames, as
the reference's does).

CodecConfig.dct_precision="high" (the relaxed analysis: three bfloat16
products, dctz_tpu/ops/dpk_fuse.py:_dot_bf16x3) takes the RELAXED
instantiations of kernels A, E, F and G on every fused route, and
transform.dot_bf16x3 in the generic chain; the verify-repair of the fused
non-DPK branch recomputes its coefficients at HIGHEST, as dctz_tpu's
_repair_fused does, and every reconstruction stays float32.

CodecConfig.dc_delta writes the DC stream of v2 float32 containers (and of
every host-coded DTZS frame) as the order-preserving u32 delta
(entropy.f32_delta; _f32_delta_dev on the device before the byte-plane
split), as dctz_tpu does; v1 keeps raw DC.

The other codec options are dispatched as the JAX package dispatches them:

  rate="auto" upgrades v1 to v2 and turns verify on (both with the
    reference's warnings), then picks brsf from AUTO_RATE_LADDER by real
    monolithic trial encodes on a sample cut on the device (_rate_sample,
    _auto_rate_brsf) and encodes at the chosen brsf.
  brsf != 1 (snapped to the header's 2**(k/8) grid, _quantize_brsf; v1
    upgrades to v2) takes kernels A + B on DPK v2 and DPK DTZS frames (the
    bin geometry is A's and E's runtime operand) and decodes on C + D; on
    host-coded v2 the generic chain, never kernels F or G (_fused_eligible).
  a block size other than 64 or a bin count other than 255 (v1 upgrades
    to v2) takes the generic chain: host-coded v2 containers and frames,
    and for the device ids the XLA chain's DPK route (_compress_chain_dpk:
    kernel J at the chunk widths it takes, multiples of 32, torch ops
    elsewhere). Decode unpacks and dequantizes in torch ops
    (idpack.unpack_ids, qz.decode_x), with kernel I where its chunk width
    holds; kernels A-G never run.
  truncate=False stores float64 data's DC and escaped AC values at 8
    bytes an item on the generic chain and the XLA chain's DPK route
    (idpack.pack_ids for the ids, torch ops for the compaction), which a
    v1 container records only in its DC section's size; decode reads the
    width from that size and expands and dequantizes in float64 torch ops.
    Float32 data with truncate=False takes the generic chain (float32
    stored values).

A DPK container whose tiles are not 256 blocks decodes through the torch
ops that take any tile (idpack.unpack_ids, qz.expand_ac), then kernel D
where its geometry holds, as the reference's XLA decode does
(dctz_tpu/api.py:200-248).

Multi-GPU (port of the reference's sharded and multi-host paths):
compress_sharded / decompress_sharded run the single-device kernels once
per shard of a device mesh (parallel/sharding.py), and
_decompress_dpk_range decodes a tile range of a DPK container, the
multi-rank restore of parallel/multihost.py.

`device` is explicit ("cuda" by default; the CPU tests pass "cpu"). On a
CUDA device every kernel of the path launches; on the CPU each kernel's
plain version runs instead.
"""

from __future__ import annotations

import dataclasses
import struct
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from .config import CodecConfig
from .core import constants as C
from .core import container as ct
from .core import entropy
from .core import quantize as qz
from .utils import timing

_DPK_META_FMT = "<QHH2x"  # n_stream (padded elements), tile_b, AC chunk width
_DPK_META_SIZE = struct.calcsize(_DPK_META_FMT)
_VERBATIM_CHUNK = 1 << 20  # split stored-verbatim sections for parallel crc


def checked_device(device) -> torch.device:
    """torch.device(device); "cuda" without a card raises (an entry point
    never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
    return device


def _check_internal_dtype(cfg: CodecConfig) -> None:
    if cfg.internal_dtype not in ("auto", "float32"):
        raise ValueError(f"internal_dtype {cfg.internal_dtype!r}")


def _relaxed(cfg: CodecConfig) -> bool:
    """The relaxed analysis (dct_precision "high") selects the kernels'
    RELAXED instantiations."""
    return cfg.dct_precision == "high"


def _resolve_ids_codec(cfg: CodecConfig) -> CodecConfig:
    """ids_codec="auto" with a v2 container means the device (DPK) coder
    (dctz_tpu/api.py:1742-1755 on its accelerator), on every device: the
    CPU run is the plain twin of the card run and writes the same
    container."""
    if cfg.ids_codec == "auto" and cfg.container == "v2":
        return dataclasses.replace(cfg, ids_codec="device")
    return cfg


def _quantize_brsf(cfg: CodecConfig) -> CodecConfig:
    """Snap cfg.brsf to the header's grid 2**(k/8), k in 1..255 offset by
    128 (container.Header stores the code k), so that the encoder runs the
    geometry the header records; warns when the value moves
    (dctz_tpu/api.py:1603-1620)."""
    import math

    if cfg.brsf == 1.0:
        return cfg
    code = min(255, max(1, round(math.log2(cfg.brsf) * 8.0) + 128))
    q = 2.0 ** ((code - 128) / 8.0)
    if q != cfg.brsf:
        warnings.warn(
            f"brsf {cfg.brsf} quantized to {q} (the container header grid)",
            stacklevel=3,
        )
        cfg = dataclasses.replace(cfg, brsf=q)
    return cfg


def _upgrade_container(cfg: CodecConfig) -> CodecConfig:
    """The prologue of dctz_tpu.compress (dctz_tpu/api.py:1800-1832), in its
    order: rate="auto" needs v2 (brsf lives in its header) and verify on
    (the widened bins rely on the repair for the bound); the v1 format has
    no geometry or brsf fields, so v1 with a non-default block size or bin
    count, or with brsf != 1, writes v2; each upgrade warns. brsf then
    snaps to the header's grid (_quantize_brsf)."""
    if cfg.rate == "auto":
        if cfg.container == "v1":
            warnings.warn(
                "rate='auto' needs the v2 container (brsf lives in its "
                "header); writing v2 instead",
                stacklevel=3,
            )
            cfg = dataclasses.replace(cfg, container="v2")
        if not cfg.verify:
            cfg = dataclasses.replace(cfg, verify=True)
    if cfg.container == "v1" and (cfg.block_size != C.BLK_SZ
                                  or cfg.nbins != C.NBINS):
        warnings.warn(
            "v1 containers only support block_size=64 / nbins=255 (the "
            "reference layout has no geometry fields); writing v2 instead",
            stacklevel=3,
        )
        cfg = dataclasses.replace(cfg, container="v2")
    if cfg.brsf != 1.0:
        if cfg.container == "v1":
            warnings.warn(
                "v1 containers cannot record brsf (fixed reference layout); "
                "writing v2 instead",
                stacklevel=3,
            )
            cfg = dataclasses.replace(cfg, container="v2")
        cfg = _quantize_brsf(cfg)
    return cfg


#: rate="auto": the candidate bin-range scale factors, powers of two on the
#: header's grid. The size against brsf falls while wider bins shrink the id
#: stream and rises once repair escapes dominate, so the ladder stops once
#: the size turns upward (dctz_tpu/api.py:1661-1665)
AUTO_RATE_LADDER = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
_AUTO_SAMPLE_ELEMS = 1 << 22  # the trials encode at most this many samples


def _rate_sample(arr, n: int, block_size: int):
    """The trials' input: the whole array up to _AUTO_SAMPLE_ELEMS samples,
    else eight block-aligned slices spread across it, concatenated
    (dctz_tpu/api.py:1668-1681). A tensor is cut where it lies, on its
    device."""
    if n <= _AUTO_SAMPLE_ELEMS:
        return arr
    k = 8
    seg = _AUTO_SAMPLE_ELEMS // k
    seg -= seg % block_size
    step = (n - seg) // (k - 1)
    step -= step % block_size
    parts = [arr[i * step : i * step + seg] for i in range(k)]
    if isinstance(arr, torch.Tensor):
        return torch.cat(parts)
    return np.concatenate(parts)


def _auto_rate_brsf(arr: torch.Tensor, n: int, cfg: CodecConfig,
                    trials: list | None = None) -> float:
    """The ladder's brsf with the smallest container on the sample
    (dctz_tpu/api.py:1684-1706). Each trial is a real monolithic compress
    with verify on, so the chosen geometry's bound behaviour is what the
    final encode ships. The ladder stops at the first trial whose repair
    could not hold the pointwise bound (its warning) and never selects it,
    or once a size exceeds 1.02 times the best so far. trials: an optional
    list collecting (brsf, size, seconds) per trial."""
    import time

    sample = _rate_sample(arr, n, cfg.block_size)
    best_b, best_sz = 1.0, None
    for b in AUTO_RATE_LADDER:
        trial_cfg = dataclasses.replace(cfg, brsf=b, rate="fixed",
                                        segment_elems=None, verify=True)
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sz = len(compress(sample, config=trial_cfg, device=sample.device))
        if trials is not None:
            trials.append((b, sz, time.perf_counter() - t0))
        if any("pointwise bound" in str(w.message) for w in caught):
            break
        if best_sz is None or sz < best_sz:
            best_b, best_sz = b, sz
        elif sz > best_sz * 1.02:
            break
    return best_b


def _resolve_segment(cfg: CodecConfig, n: int) -> int | None:
    """Segment size for the pipelined DTZS path, or None for monolithic
    (dctz_tpu/api.py:1709-1739): "auto" (the default) segments v2 EC and
    QT arrays of stream.AUTO_THRESHOLD elements or more into
    stream.DEFAULT_SEGMENT-element frames; an int segments arrays of at
    least two such segments; 0 or None never segments."""
    from . import stream

    se = cfg.segment_elems
    if se == "auto":
        if (cfg.container == "v2" and cfg.mode in ("ec", "qt")
                and n >= stream.AUTO_THRESHOLD):
            return stream.DEFAULT_SEGMENT
        return None
    if se and n >= 2 * se:
        return se
    return None


def _zstd_on(cfg: CodecConfig) -> bool:
    return cfg.host_codec == "auto" and entropy.zstd_available()


def _stats_device(x_padded: torch.Tensor, n_real: int, sf_adj: int):
    """(sf, mean) over a zero-padded array (scalars of its dtype on its
    device)."""
    from .core.stats import amax_mean, scaling_factor

    amax, mean = amax_mean(x_padded, n_real)
    return scaling_factor(amax, sf_adj), mean


def _plane_split2(dc: torch.Tensor, ac: torch.Tensor, dcd: bool = False):
    """Byte planes of the float32 DC/AC streams on the device: plane k is the
    k-th little-endian byte of each item (entropy.shuffle_bytes' layout).
    dcd: delta-code the DC stream first (_f32_delta_dev), as
    dctz_tpu/api.py:_plane_split2 does; the host packer sets the header's
    dcd flag (_float_sections_planes)."""

    def split(a):
        u = a.contiguous().view(torch.int32)
        return torch.stack([((u >> (8 * k)) & 255).to(torch.uint8) for k in range(4)])

    return split(_f32_delta_dev(dc) if dcd else dc), split(ac)


def _combine_planes(pl: torch.Tensor) -> torch.Tensor:
    """Inverse of _plane_split2: (4, ...) u8 planes -> float32."""
    u = pl[0].to(torch.int32)
    for k in range(1, pl.shape[0]):
        u = u | (pl[k].to(torch.int32) << (8 * k))
    return u.view(torch.float32)


def _u32_of(a: torch.Tensor) -> torch.Tensor:
    """The bits of a float32 tensor as u32 values in int64."""
    return a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _f32_of(u: torch.Tensor) -> torch.Tensor:
    """Inverse of _u32_of: int64 u32 values -> float32 of those bits."""
    u = torch.where(u >= (1 << 31), u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def _restart_rows(u: torch.Tensor) -> torch.Tensor:
    """(k, DC_RESTART) rows of u, the last one zero-padded: the delta
    restarts at every row."""
    r = entropy.DC_RESTART
    k = -(-u.shape[0] // r)
    return torch.nn.functional.pad(u, (0, k * r - u.shape[0])).reshape(k, r)


def _f32_delta_dev(dc: torch.Tensor) -> torch.Tensor:
    """Device twin of entropy.f32_delta (exact u32 arithmetic, carried in
    int64, as dctz_tpu/api.py:_f32_delta_dev computes it in uint32): each
    item's order-preserving u32 code minus the previous one, wrapping,
    restarting every DC_RESTART items."""
    u = _u32_of(dc)
    m2 = _restart_rows(torch.where((u >> 31) != 0, (~u) & 0xFFFFFFFF, u | 0x80000000))
    d = torch.cat([m2[:, :1], (m2[:, 1:] - m2[:, :-1]) & 0xFFFFFFFF], dim=1)
    return _f32_of(d.reshape(-1)[:dc.shape[0]])


def _f32_delta_inv_dev(dc: torch.Tensor) -> torch.Tensor:
    """Device twin of entropy.f32_delta_inv (exact u32 arithmetic, carried in
    int64). Item 0 sits on a restart boundary."""
    m2 = _restart_rows(_u32_of(dc))
    m = (torch.cumsum(m2, dim=1) & 0xFFFFFFFF).reshape(-1)[:dc.shape[0]]
    return _f32_of(torch.where((m >> 31) != 0, m & 0x7FFFFFFF, (~m) & 0xFFFFFFFF))


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
    f_packed = pool.submit(timing.task("section.ids", _packed_task))
    f_exc = pool.submit(timing.task("section.ids", _exc_task))
    f_meta = pool.submit(timing.task("section.ids", _meta_task))
    with timing.span("section.ids", cpu=True):
        width_sec = _side_sec(width.tobytes())
    return (width_sec, f_packed.result(), f_exc.result(), f_meta.result())


def _dpk_v2_streams(header, width, packed_rows, exc_rows, exc_counts, counts,
                    ac_chunks, dc, n_pad, cfg, *, dc_planes=None,
                    ac_planes=None, n_stream=None) -> tuple:
    """The six sections of a DPK v2 container, coded on the section pool
    (spans section.dc, section.ac, section.ids); dc_planes/ac_planes are the
    device-split byte planes replacing dc and ac_chunks (the same bytes, no
    host shuffle). n_pad: the padded length, whose chunk width the rows
    take; n_stream: the id stream's length written to the meta section,
    n_pad unless given (the XLA chain's containers store the true length,
    dctz_tpu/api.py:1940-1943)."""
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
        f_dc = pool.submit(timing.task("section.dc", _float_sections_planes),
                           list(dc_planes), cfg, header, _dcd_on(cfg, header))
    else:
        f_dc = pool.submit(timing.task("section.dc", _float_sections),
                           dc.tobytes(), dc.dtype.itemsize, cfg, header, True)
    f_ac = pool.submit(timing.task("section.ac", _ac_task))
    return _dpk_sections(
        width, packed_rows, exc_rows, exc_counts, counts, idpack.B_DEFAULT,
        qz.chunk_width(n_pad, cfg.block_size),
        n_pad if n_stream is None else n_stream, cfg, header,
    ) + (f_dc.result(), f_ac.result())


def _resolve_input(x, device, cfg: CodecConfig):
    """(a flat float32 or float64 tensor on `device`, the source dtype as a
    numpy dtype). internal_dtype="float32" casts float64 input to float32
    on the device, the one downcast (dctz_tpu/api.py:1758-1779); "auto"
    keeps float64 at full width. The header records the source dtype."""
    if isinstance(x, torch.Tensor):
        arr = x
    else:
        a = np.asarray(x)
        if a.dtype not in (np.float32, np.float64):
            raise TypeError(f"unsupported dtype {a.dtype}; use float32/float64")
        arr = torch.from_numpy(np.ascontiguousarray(a))
    if arr.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {arr.dtype}; use float32/float64")
    device = checked_device(device)
    src_dtype = np.dtype(np.float64 if arr.dtype == torch.float64 else np.float32)
    arr = timing.to_device(arr.reshape(-1), device)
    if cfg.internal_dtype == "float32":
        arr = arr.to(torch.float32)
    return arr, src_dtype


def compress(
    x: Any,
    error_bound: float = 1e-3,
    mode: str = "ec",
    *,
    config: CodecConfig | None = None,
    timer=None,
    device: str | torch.device = "cuda",
) -> bytes:
    """Compress a flat float32 or float64 array (numpy or torch); returns
    the container bytes. The signature of dctz_tpu.compress plus `device`:
    with no config it writes CodecConfig(mode=mode,
    error_bound=error_bound), a v1 container. A v2 config writes a DPK
    container (ids_codec "device" or "auto") or a host-coded v2 container
    (ids_codec "deflate" or "rans"). A segmented array (cfg.segment_elems,
    _resolve_segment) becomes a DTZS stream: of DPK frames with the device
    ids on float32 data, else of host-coded v2 frames (v1 configurations
    and float64 data included). Float64 runs at full width unless
    cfg.internal_dtype is "float32" (_resolve_input). timer: a
    utils.timing.StageTimer that takes the call's stages, spans and
    counters; without one (and with no profiler recording) nothing is
    traced."""
    cfg = config or CodecConfig(mode=mode, error_bound=error_bound)
    cfg = _resolve_ids_codec(_upgrade_container(cfg))
    with timing.using(timer) as timer:
        return _compress(x, cfg, timer, device)


def _compress(x, cfg: CodecConfig, timer, device) -> bytes:
    """compress()'s body, traced into timer (utils/timing.using)."""
    _check_internal_dtype(cfg)
    with timer.stage("transfer"):
        arr, src_dtype = _resolve_input(x, device, cfg)
    n = int(arr.shape[0])
    if n == 0:
        raise ValueError("cannot compress an empty array")
    if cfg.rate == "auto":
        with timer.stage("rate"):
            cfg = dataclasses.replace(
                cfg, rate="fixed",
                brsf=_auto_rate_brsf(arr, n, cfg,
                                     getattr(timer, "rate_trials", None)))
    seg = _resolve_segment(cfg, n)
    if seg:
        # the pipelined path: the device encodes segment k + 1 while a host
        # worker packs segment k; the input already lies on `device`, so the
        # statistics reduce there and the segments are slices of it. With
        # internal_dtype="float32" the frames declare the cast array's
        # float32, as the reference's do (it casts before its stream writer)
        import io

        from . import stream

        buf = io.BytesIO()
        with timer.stage("pipeline"):
            stream.compress_stream(arr, buf, config=cfg, segment_elems=seg,
                                   device=arr.device, timer=timer)
        return buf.getvalue()
    if _fused_eligible(cfg, arr, n):
        return _compress_fused(arr, n, cfg, timer, src_dtype)
    if cfg.container == "v2" and cfg.ids_codec == "device":
        return _compress_chain_dpk(arr, n, cfg, timer, src_dtype)
    return _compress_generic(arr, n, cfg, timer, src_dtype)


def _fused_eligible(cfg: CodecConfig, arr: torch.Tensor, n: int) -> bool:
    """dctz_tpu/api.py:269-305, with its TPU dispatch taken: the fused
    kernels take EC or QT on float32 at the default geometry (block size 64,
    255 bins) with truncate on, every v2 container and a v1 container only
    when n % 1024 == 0 (the reference stream layout allows no padding).
    brsf != 1 rides only the x-input DPK kernel (A), which takes the bin
    geometry as an operand; the other fused branches (F, G) leave it to the
    generic chain, whose container stores the true length."""
    base = (cfg.mode in ("ec", "qt") and cfg.truncate
            and cfg.block_size == C.BLK_SZ and cfg.nbins == C.NBINS
            and arr.dtype == torch.float32
            and (cfg.container == "v2" or n % 1024 == 0))
    if not base or cfg.brsf == 1.0:
        return base
    return cfg.container == "v2" and cfg.ids_codec == "device"


def _warn_bound() -> None:
    timing.count("bound_shortfalls")
    warnings.warn(
        "verify-repair could not fully satisfy the pointwise bound "
        "(float32-truncation floor)",
        stacklevel=5,
    )


def _compress_fused(arr: torch.Tensor, n: int, cfg: CodecConfig, timer,
                    src_dtype: np.dtype) -> bytes:
    """dctz_tpu.api._compress_fused: the DPK branch, or the non-DPK branch
    for v1 and host-coded v2. The latter pads to the 1024 quantum, then
    without verify runs fused_encode_pipeline(_qt) (F, or E and G, then H);
    with verify it runs F or G and _repair_fused, skipping the pipeline's
    compaction that the JAX package computes and discards before its repair
    (dctz_tpu/api.py:420-448). The id stream holds n ids for v1 (n == n_pad
    there) and n_pad for v2 (dctz_tpu/api.py:526). The header declares
    src_dtype (float64 for float64 input cast by internal_dtype="float32")."""
    from . import stream
    from .ops import fused_encode as fe

    if cfg.container == "v2" and cfg.ids_codec == "device":
        return _compress_fused_dpk(arr, n, cfg, timer, src_dtype)
    eb, relaxed = cfg.error_bound, _relaxed(cfg)
    with timer.stage("device"):
        x = stream._on_device(arr, arr.device)
        n_pad = int(x.shape[0])
        sf, mean = _stats_device(x, n, cfg.sf_adj)
        ok = None
        if cfg.verify:
            if cfg.mode == "qt":
                ids, dcac, qtable = fe.fused_encode_qt(x, sf, eb, relaxed=relaxed)
            else:
                ids, dcac = fe.fused_encode_ec(x, sf, eb, relaxed=relaxed)
                qtable = None
            q, ok = _repair_fused(x, sf, ids, dcac[:, 0], n, cfg, qtable)
        elif cfg.mode == "qt":
            q = fe.fused_encode_pipeline_qt(x, sf, eb, relaxed=relaxed)
        else:
            q = fe.fused_encode_pipeline(x, sf, eb, relaxed=relaxed)
        qtable = (fe.patch_slot0(q.qtable, q.dc, n) if q.qtable is not None
                  else None)
    stream_len = n if cfg.container == "v1" else n_pad
    return _pack_host_coded(q, qtable, ok, sf, mean, n, stream_len, cfg, timer,
                            src_dtype)


def _repair_fused(x: torch.Tensor, sf: torch.Tensor, ids: torch.Tensor,
                  dc: torch.Tensor, n: int, cfg: CodecConfig, qtable=None):
    """Verify-repair of the fused non-DPK branch (dctz_tpu/api.py:308-332):
    recompute the coefficients with a torch matmul (as the JAX package does
    with XLA; ulp differences from kernel F or G are absorbed by the bin-id
    indirection), repair over the padded length with the tolerance of the n
    real samples, and compact (kernel H). Returns (Quantized, ok). The
    coefficients are HIGHEST whatever cfg.dct_precision says: the
    reference's _repair_fused calls transform.forward with no precision."""
    from .ops import fused_encode as fe
    from .ops import repair

    n_pad = x.shape[0]
    bs = cfg.block_size
    coeffs = _forward_padded(x / sf, bs)
    tol = fe.tolerance(x, n, cfg.error_bound)
    ids2, ok = repair.verify_repair(x, coeffs, sf, ids, dc, n_pad, n, cfg,
                                    tol, qtable)
    acm = qz.ac_mask(n_pad // bs, bs, n_pad, x.device)
    dense = repair.stored_dense(coeffs, ids2, acm, cfg, qtable)
    return qz.repack(ids2, dense, dc, qtable, n_pad, cfg), ok


def _forward_padded(xs: torch.Tensor, bs: int,
                    precision: str = "highest") -> torch.Tensor:
    """(nblk, bs) coefficients of a flat scaled array: whole blocks, and a
    partial last block through the rem-point basis, zero-padded to a row
    (transform.forward then dctz_tpu.api._pad_coeffs)."""
    from .core import transform

    main_c, tail_c = transform.forward(xs, bs, precision)
    if tail_c.shape[0] == 0:
        return main_c
    tail_row = torch.nn.functional.pad(tail_c, (0, bs - tail_c.shape[0]))
    return torch.cat([main_c, tail_row[None, :]])


def _chain_stats(arr: torch.Tensor, n: int, cfg: CodecConfig):
    """(sf, mean, tolerance or None) of a whole array in its dtype, as
    dctz_tpu/api.py:_encode_device takes them (calc_data_stat, and
    repair.verify_repair's own tolerance when cfg.verify)."""
    from .core.stats import amax_mean, scaling_factor
    from .ops import fused_encode as fe

    amax, mean = amax_mean(arr, n)
    tol = fe.tolerance(arr, n, cfg.error_bound) if cfg.verify else None
    return scaling_factor(amax, cfg.sf_adj), mean, tol


def _compress_generic(arr: torch.Tensor, n: int, cfg: CodecConfig,
                      timer, src_dtype: np.dtype) -> bytes:
    """The generic chain (dctz_tpu/api.py:1870-1978, _encode_device), taken
    by the v1 and host-coded v2 containers the fused kernels do not take
    (_fused_eligible): v1 with n % 1024 != 0, float64 data (for v1 the
    float64 parity path), brsf != 1 on host-coded v2, a non-default block
    size or bin count, truncate=False. Stats over
    the n samples, then the device stage of a host-coded DTZS frame
    (stream._encode_segment) with this array's own sf, tolerance and
    qtable, in the array's dtype. The ids of the n real positions make the
    stream."""
    from . import stream

    with timer.stage("device"):
        sf, mean, tol = _chain_stats(arr, n, cfg)
        q, ok = stream._encode_segment(arr, n, sf, tol, cfg)
    return _pack_host_coded(q, q.qtable, ok, sf, mean, n, n, cfg, timer,
                            src_dtype)


def _compress_chain_dpk(arr: torch.Tensor, n: int, cfg: CodecConfig,
                        timer, src_dtype: np.dtype) -> bytes:
    """The XLA chain's DPK route (dctz_tpu/api.py:1870-1960), taken by v2
    containers with the device ids that the fused kernels do not take
    (_fused_eligible): float64 data, a non-default block size or bin
    count, truncate=False. The generic chain up to the stored values
    (stream._quantize_segment) in the array's dtype, then the id coding and
    the AC compaction: with float32 stored values pack_ids_with_ac (kernel
    B at its geometry, kernel J at other chunk widths that are multiples of
    32, torch ops elsewhere), retried at full chunk width on exception
    overflow; with full-width float64 stored values (truncate=False)
    pack_ids for the ids and the chain's own compaction (qz.repack, torch
    ops at 8 bytes an item) for the AC, as the reference does. The
    container's id stream has the TRUE length n: its last block is partial
    and decodes through the rem-point basis. The arrays are padded to whole
    blocks only, so the chunk width can be that of one block. The header
    declares src_dtype."""
    from . import stream
    from .ops import idpack

    bs = cfg.block_size
    with timer.stage("device"):
        sf, mean, tol = _chain_stats(arr, n, cfg)
        ids, dc, vals, qtable, ok = stream._quantize_segment(arr, n, sf, tol,
                                                             cfg)
        ids8 = ids.to(torch.uint8)
        n_pad = ids.numel()
        cw = qz.chunk_width(n_pad, bs)
        if dc.dtype == torch.float32:
            dcac = vals.to(torch.float32)
            dcac[:, 0] = dc

            def pack(cape):
                return idpack.pack_ids_with_ac(ids8, dcac, n, idpack.B_DEFAULT,
                                               cape)

            outs = pack(idpack.CAPE)
            if timing.item(outs[7]):
                timing.count("retries")
                outs = pack(cw)
            width, packed, exc_rows, exc_counts, ac, ac_counts, dc, _ovf = outs
        else:
            width, packed, exc_rows, exc_counts, ovf = idpack.pack_ids(
                ids8, n, idpack.B_DEFAULT, idpack.CAPE)
            if timing.item(ovf):
                timing.count("retries")
                width, packed, exc_rows, exc_counts, _ = idpack.pack_ids(
                    ids8, n, idpack.B_DEFAULT, cw)
            q = qz.repack(ids, vals, dc, qtable, n, cfg)
            ac, ac_counts = q.ac_buf, q.ac_count
        # the qtable's slot 0 is already the last block's DC in the data's
        # dtype (qz.qtable_colmax); a float64 header keeps raw DC (_dcd_on)
        dcd = (cfg.dc_delta and cfg.container == "v2"
               and src_dtype == np.float32)
        planes = (_plane_split2(dc, ac, dcd) if _plane_mode(cfg, dc)
                  else None)
    with timer.stage("transfer"):
        dc_s, ac_s = planes if planes is not None else (dc, ac)
        host = stream._start_pull([width, packed, exc_rows, exc_counts,
                                   ac_counts, dc_s, ac_s, ok, qtable])()
        sf, mean = timing.item(sf), timing.item(mean)
    bound_bad: list[int] = []
    with timer.stage("zlib"):
        blob = stream._pack_segment_dpk(host, planes is not None, n, n_pad, sf,
                                        mean, cfg, bound_bad, dtype=src_dtype,
                                        n_stream=n)
    if bound_bad:
        _warn_bound()
    return blob


def _header(cfg: CodecConfig, n: int, ac_count: int, sf: float,
            mean: float, dtype=np.float32) -> ct.Header:
    """The header of a container of n elements of `dtype` (float32 or
    float64), its section sizes and flags still to be filled."""
    return ct.Header(
        dtype=np.dtype(dtype),
        num_elements=n,
        error_bound=cfg.error_bound,
        ac_count=ac_count,
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


def _pack_host_coded(q, qtable, ok, sf, mean, n: int, stream_len: int,
                     cfg: CodecConfig, timer, dtype=np.float32) -> bytes:
    """Pull the device streams (pinned memory on the card) and assemble a v1
    or host-coded v2 container of `dtype`: the first stream_len ids, the DC
    stream and the tight AC stream, float32 or, with truncate off, of the
    data's dtype (dctz_tpu/api.py:524-545, :2052-2101), the qtable in
    `dtype`. A v1 container records nothing of the width: its decoder reads
    it from the DC section's size."""
    from . import stream

    with timer.stage("transfer"):
        ids, dc, ac_rows, counts, qt, ok = stream._start_pull(
            [q.bin_ids, q.dc, q.ac_buf, q.ac_count, qtable, ok])()
        sf, mean = timing.item(sf), timing.item(mean)
    if ok is not None and not bool(ok):
        _warn_bound()
    header = _header(cfg, n, int(counts.sum()), sf, mean, dtype)
    with timer.stage("zlib"):
        with timing.span("zlib.sections", cpu=True, tile=True):
            ac = entropy.take_row_prefixes(ac_rows, counts)
            flat_ids = ids.reshape(-1)[:stream_len].tobytes()
            if cfg.container == "v1":
                bz, dz, az = entropy.deflate_streams(
                    [flat_ids, dc.tobytes(), ac.tobytes()], cfg.zlib_level)
                header.bindex_nbytes, header.dc_nbytes, header.ac_nbytes = (
                    len(bz), len(dz), len(az))
            else:
                header.shuffle = cfg.shuffle
                streams = _ids_streams(flat_ids, cfg, header) + (
                    _float_sections(dc.tobytes(), dc.dtype.itemsize, cfg,
                                    header, dc=True),
                    _float_sections(ac.tobytes(), ac.dtype.itemsize, cfg,
                                    header),
                )
        with timing.span("zlib.container", cpu=True, tile=True):
            if cfg.container == "v1":
                return ct.pack_v1(header, bz, dz, az, qt)
            return ct.pack_v2(header, streams, qt, cfg.chunk_bytes)


def _ids_streams(ids_bytes: bytes, cfg: CodecConfig, header: ct.Header):
    """The bin-index section(s) of a host-coded v2 container: (packed,
    exceptions) with the IDS4 nibble filter, the packed nibbles in native
    rANS for ids_codec="rans" else Huffman-only deflate; or the raw stream
    deflated (a copy of dctz_tpu.api._ids_streams). ids_codec="auto"
    reaches here from a DTZS frame of a v1 configuration: rANS when the
    native library is available, else deflate, the reference's own choice
    (dctz_tpu/api.py:691-697); the header's rans flag records it."""
    if not cfg.ids4:
        level = cfg.ids_zlib_level or cfg.zlib_level
        return (entropy.chunked_deflate(ids_bytes, cfg.chunk_bytes, level),)
    header.ids4 = True
    packed, exc = entropy.pack_ids4(ids_bytes)
    header.zst = cfg.ids_zlib_level is None and _zstd_on(cfg)
    exc_sec = (
        entropy.chunked_zstd(exc, cfg.chunk_bytes, 1)
        if header.zst
        else entropy.chunked_deflate(exc, cfg.chunk_bytes, cfg.ids_zlib_level or 1)
    )
    from . import native

    if cfg.ids_codec == "rans" or (cfg.ids_codec == "auto" and native.available()):
        header.rans = True
        return ([native.rans_compress(packed)], exc_sec)
    return (
        entropy.chunked_deflate(packed, cfg.chunk_bytes, 1, entropy.HUFFMAN_ONLY),
        exc_sec,
    )


def _compress_fused_dpk(arr: torch.Tensor, n: int, cfg: CodecConfig,
                        timer, src_dtype: np.dtype) -> bytes:
    """The DPK EC/QT branch of dctz_tpu.api._compress_fused, as the
    one-segment case of the stream writer: pad to the tile quantum, stats,
    tolerance, [QT: kernel E], then the segment's device stage (kernels
    A + B, byte planes; stream._encode_segment_dpk) and host stage
    (stream._pack_segment_dpk)."""
    from . import stream
    from .ops import fused_encode

    with timer.stage("device"):
        x = stream._on_device(arr, arr.device)
        sf, mean = _stats_device(x, n, cfg.sf_adj)
        # float32 arithmetic, as the monolithic JAX path (the stream writer
        # computes its global tolerance in doubles instead)
        tol = fused_encode.tolerance(x, n, cfg.error_bound)
        qtable = (fused_encode.qtable_qmax(x, sf, cfg.error_bound,
                                           relaxed=_relaxed(cfg))
                  if cfg.mode == "qt" else None)
        outs, planes, qtable = stream._encode_segment_dpk(x, n, sf, tol, cfg,
                                                          qtable, src_dtype)
    with timer.stage("transfer"):
        host = stream._start_pull(stream._pull_list(outs, planes, qtable, cfg))()
        sf, mean = timing.item(sf), timing.item(mean)
    bound_bad: list[int] = []
    with timer.stage("zlib"):
        blob = stream._pack_segment_dpk(
            host, planes is not None, n, int(x.shape[0]), sf, mean, cfg,
            bound_bad, dtype=src_dtype,
        )
    if bound_bad:
        _warn_bound()
    return blob


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
    return _decode_float_section(header, chunks)


def _decode_float_section(header: ct.Header, chunks, dc: bool = False) -> bytes:
    """Inverse of _float_sections; dc=True also inverts the DC delta
    (header.dcd) on the host, as dctz_tpu's generic decode does."""
    if header.plc:
        raw = entropy.decode_float_stream(chunks)
    else:
        raw = entropy.chunked_inflate(chunks)
        if header.shuffle:
            raw = entropy.unshuffle_bytes(raw, header.stored_dtype.itemsize)
    if dc and header.dcd:
        raw = entropy.f32_delta_inv(np.frombuffer(raw, np.float32)).tobytes()
    return raw


def _dpk_packed(header: ct.Header, chunks, out=None):
    """The tight bytes of a DPK container's packed-id section, whole; out
    (a writable uint8 array it must fill, entropy.join_into) takes them in
    place of a join."""
    from . import native

    if header.dpks:
        return entropy.chunked_unzstd(chunks, out)
    if header.dpkz:
        return entropy.chunked_inflate(chunks, out)
    entropy.verify_chunk_range(chunks)
    if header.dpkr:
        raw = native.rans_decompress(entropy.join_chunks(chunks))
        return raw if out is None else entropy.join_into((raw,), out)
    return entropy.join_chunks(chunks) if out is None else entropy.join_into(chunks, out)


def _dpk_exceptions(header: ct.Header, chunks, out=None):
    """The tight bytes of a DPK container's id-exception section, whole;
    out as _dpk_packed's."""
    if header.zst:
        return entropy.chunked_unzstd(chunks, out)
    if header.rans:
        from . import native

        entropy.verify_chunk_range(chunks)
        raw = native.rans_decompress(b"".join(chunks))
        return raw if out is None else entropy.join_into((raw,), out)
    return entropy.chunked_inflate(chunks, out)


def _dpk_geometry(header: ct.Header, meta):
    """(n_stream, tile_b, cw, nblk, tiles, exc_counts, ac_counts) of a DPK
    container from its decoded meta section; the counts (one a chunk row)
    as int64."""
    from .ops import idpack

    n_stream, tile_b, cw = struct.unpack_from(_DPK_META_FMT, meta, 0)
    nblk = -(-n_stream // header.block_size)
    n_chunks = (nblk * header.block_size) // cw
    off = _DPK_META_SIZE
    exc_counts = np.frombuffer(meta, np.uint16, n_chunks, off).astype(np.int64)
    ac_counts = np.frombuffer(
        meta, np.uint16, n_chunks, off + 2 * n_chunks
    ).astype(np.int64)
    return (n_stream, tile_b, cw, nblk, idpack.tiles_of(nblk, tile_b),
            exc_counts, ac_counts)


def _cape_tier(peak: int, cw: int) -> int:
    """Smallest exception row-capacity tier covering the per-chunk peak."""
    tiers = [c for c in (32, 64, 128, 256) if c < cw] + [cw]
    return next(c for c in tiers if c >= min(peak, cw))


def _dpk_host_rebuild(header: ct.Header, streams, tile_range=None,
                      float_planes=True, meta=None):
    """Re-inflate a DPK container's side streams and re-pad the tight layouts
    into fixed-capacity rows on the host (dctz_tpu/api.py:936-1098), for the
    callers that need host rows: the tile-range restore, the sharded decode
    and dctz_dump (a whole container's decompress lays its rows out on the
    device instead, _dpk_decode_prep). Returns (width (T,bs), rows,
    exc_rows, dc_raw, ac_raw, n_stream, tile_b, cw, ac_counts, nblk).
    float_planes: True gives 4-byte PLC DC and AC sections as ("planes",
    [plane bytes]) (_float_raw), False as bytes, "skip" hands back their
    chunk lists untouched (the tile-range decode decodes them itself,
    _float_section_range). meta: the meta section already decoded
    (_dpk_meta with_bytes=True).

    tile_range=(t0, t1): rebuild only tiles [t0, t1), the multi-rank
    restore (parallel/multihost.py). width, rows and exc_rows cover just
    the slice: the bulk packed section is byte-range-sliced (zero-copy and
    crc-checked over its covering chunks for a verbatim section,
    chunk-range-decoded for the zstd and deflate ones), the exceptions are
    decoded over their covering chunks; meta, dc_raw, ac_raw, ac_counts and
    nblk stay GLOBAL (the caller slices DC and AC by its own count
    prefixes)."""
    from . import native
    from .ops import idpack

    widths_z, packed_raw, exc_z, meta_z, dz, az = streams
    pool = entropy.section_pool()
    _side = entropy.chunked_unzstd if header.zst else entropy.chunked_inflate

    def _tight_range(b0: int, b1: int):
        """Decoded bytes [b0, b1) of the packed section, touching as little
        of it as possible (the joined rANS stream has no random access:
        decoded whole, then sliced)."""
        if header.dpks:
            return entropy.decode_chunk_range(packed_raw, b0, b1,
                                              entropy.zstd_decompress)
        if header.dpkz:
            return entropy.decode_chunk_range(packed_raw, b0, b1, entropy.inflate)
        if header.dpkr:
            entropy.verify_chunk_range(packed_raw)
            return memoryview(native.rans_decompress(
                entropy.join_chunks(packed_raw)))[b0:b1]
        entropy.verify_covering_chunks(packed_raw, b0, b1)
        return memoryview(entropy.join_chunks(packed_raw))[b0:b1]

    def _exc_range(e0: int, e1: int):
        """Exception bytes [e0, e1), one byte an item."""
        if header.zst:
            return entropy.decode_chunk_range(exc_z, e0, e1, entropy.zstd_decompress)
        if header.rans:
            entropy.verify_chunk_range(exc_z)
            return memoryview(native.rans_decompress(b"".join(exc_z)))[e0:e1]
        return entropy.decode_chunk_range(exc_z, e0, e1, entropy.inflate)

    f_width = pool.submit(timing.task("section.ids", _side), widths_z)
    if tile_range is None:
        f_tight = pool.submit(timing.task("section.ids", _dpk_packed), header,
                              packed_raw)
        f_exc = pool.submit(timing.task("section.ids", _dpk_exceptions), header,
                            exc_z)
    if float_planes == "skip":
        f_dc = f_ac = None
    else:
        f_dc = pool.submit(timing.task("section.dc", _float_raw), header, dz,
                           bool(float_planes))
        f_ac = pool.submit(timing.task("section.ac", _float_raw), header, az,
                           bool(float_planes))

    if meta is None:
        with timing.span("section.ids", cpu=True):
            meta = _side(meta_z)
    (n_stream, tile_b, cw, nblk, t, exc_counts,
     ac_counts) = _dpk_geometry(header, meta)
    bs = header.block_size
    n_chunks = exc_counts.size

    width = np.frombuffer(f_width.result(), np.uint8, bs * t).reshape(t, bs)
    bpr = idpack.packed_nbytes(width.reshape(-1), tile_b)
    if tile_range is not None:
        t0, t1 = tile_range
        epc = (tile_b * bs) // cw  # chunk rows per tile
        cum = np.concatenate(([0], np.cumsum(bpr, dtype=np.int64)))
        tight = _tight_range(int(cum[t0 * bs]), int(cum[t1 * bs]))
        width = width[t0:t1]
        bpr = bpr[t0 * bs : t1 * bs]
        c0, c1 = t0 * epc, min(t1 * epc, n_chunks)
        ecum = np.concatenate(([0], np.cumsum(exc_counts, dtype=np.int64)))
        exc_counts = exc_counts[c0:c1]
        f_exc_r = pool.submit(timing.task("section.ids", _exc_range),
                              int(ecum[c0]), int(ecum[c1]))
        f_rows = pool.submit(timing.task("section.ids", lambda: (
            entropy.pad_row_prefixes(tight, bpr, tile_b // 2, np.uint8))))
        exc_tight = np.frombuffer(f_exc_r.result(), np.uint8)
    else:
        f_rows = pool.submit(timing.task("section.ids", lambda: (
            entropy.pad_row_prefixes(f_tight.result(), bpr, tile_b // 2,
                                     np.uint8))))
        exc_tight = np.frombuffer(f_exc.result(), np.uint8)
    cape = _cape_tier(int(exc_counts.max()) if exc_counts.size else 0, cw)
    exc_rows = entropy.pad_row_prefixes(exc_tight, exc_counts, cape, np.uint8)
    return (width, f_rows.result(), exc_rows,
            dz if f_dc is None else f_dc.result(),
            az if f_ac is None else f_ac.result(),
            n_stream, tile_b, cw, ac_counts, nblk)


def _capc_tier(peak: int, cw: int) -> int:
    """Smallest AC row-capacity tier covering the per-chunk peak."""
    tiers = [tt for tt in (32, 64, 128) if tt < cw] + [cw]
    return next(tt for tt in tiers if tt >= min(peak, cw))


def _stored_dtype(header: ct.Header, dc_nbytes: int, nblk: int,
                  cfg: CodecConfig):
    """(the stored float dtype, cfg) from the DC section's length: a float64
    container whose DC section holds 8-byte items was written with
    truncate=False, full-width streams (dctz_tpu/api.py:1107-1114); cfg then
    says so."""
    stored = np.dtype(np.float32)
    if dc_nbytes == nblk * header.dtype.itemsize and header.dtype != stored:
        return header.dtype, dataclasses.replace(cfg, truncate=False)
    return stored, cfg


def _planes4(header: ct.Header, chunks) -> bool:
    """Whether a DC or AC section is PLC-coded 4-byte items, whose byte
    planes the decode uploads as they are (_float_raw's "planes")."""
    return bool(header.plc and len(chunks) and chunks[0][0] == 4)


def _a16(n: int) -> int:
    return -(-n // 16) * 16


class _Upload(NamedTuple):
    """Where _dpk_decode_prep put a DPK container's sections in its upload
    buffer (byte offsets, each on 16 bytes), and the geometry of the rows
    that kernel N lays out from them. The buffer opens with n_off bytes of
    int64 prefix offsets: of the packed rows (rows + 1), the exception rows
    (nc + 1) and the AC rows (nc + 1; in bytes for AC sections that are not
    planes)."""

    n_stream: int
    tile_b: int
    cw: int
    cfg: CodecConfig
    nblk: int
    tiles: int
    nc: int
    cape: int
    capc: int
    stored: np.dtype  # the DC and AC items' dtype
    dc_planes: bool  # (4, nblk) byte planes at o_dc, else host array 1
    ac_planes: bool  # (4, ac_count) byte planes at o_ac, else the last
    ac_count: int
    n_off: int
    o_width: int
    o_dc: int
    o_ac: int
    o_exc: int
    n_exc: int
    o_packed: int
    n_packed: int

    def layout_args(self, buf, ac=None) -> tuple:
        """dpk_fuse.dpk_rows_layout's arguments from the upload buffer buf
        (a uint8 tensor on any device): the tight packed, exception and AC
        streams, each beside its prefix offsets and its rows' capacity. ac:
        the tight AC bytes where they are not planes in buf."""
        rows, nc = self.tiles * self.cfg.block_size, self.nc
        offs = buf[: self.n_off].view(torch.int64)
        capc = self.capc
        if self.ac_planes:
            ac = buf[self.o_ac : self.o_ac + 4 * self.ac_count].view(4, self.ac_count)
        else:
            capc *= self.stored.itemsize
        return (buf[self.o_packed : self.o_packed + self.n_packed], offs[: rows + 1],
                self.tile_b // 2, buf[self.o_exc : self.o_exc + self.n_exc],
                offs[rows + 1 : rows + nc + 2], self.cape, ac, offs[rows + nc + 2 :],
                capc)


def _dpk_decode_prep(header: ct.Header, streams):
    """Host stage of a whole DPK container's decompress -> (host_arrays,
    upload): the sections inflated with no re-pad, each straight into its
    place in one uint8 upload buffer (host_arrays[0], laid out by upload,
    an _Upload), beside the tight row offsets and the tiers (cape, capc)
    kernel N pads to (_decode_dpk_upload). DC and AC sections that are not
    4-byte PLC planes (float64 at full width, non-PLC containers) follow as
    host arrays of their own: DC as (nblk,) of the stored dtype, AC as its
    tight bytes. Every row length is checked here against its capacity and
    every stream against the rows' total, as the host re-pad did."""
    from .ops import idpack

    widths_z, packed_raw, exc_z, meta_z, dz, az = streams
    pool = entropy.section_pool()
    _side = entropy.chunked_unzstd if header.zst else entropy.chunked_inflate
    with timing.span("section.ids", cpu=True):
        meta = _side(meta_z)
        (n_stream, tile_b, cw, nblk, t, exc_counts,
         ac_counts) = _dpk_geometry(header, meta)
        bs = header.block_size
        rows, nc = t * bs, exc_counts.size
        width = np.frombuffer(_side(widths_z), np.uint8, rows)
    bpr = idpack.packed_nbytes(width, tile_b)
    peak_e = int(exc_counts.max()) if nc else 0
    peak_a = int(ac_counts.max()) if nc else 0
    if ((rows and int(bpr.max()) > tile_b // 2) or max(peak_e, peak_a) > cw
            or int(ac_counts.sum()) != header.ac_count):
        raise ValueError("corrupted container: a row's length past its "
                         "capacity, or the AC counts off the AC section's")
    dc_pl, ac_pl = _planes4(header, dz), _planes4(header, az)
    n_off = 8 * (rows + 2 * nc + 3)
    o_width = _a16(n_off)
    o_dc = _a16(o_width + rows)
    o_ac = _a16(o_dc + (4 * nblk if dc_pl else 0))
    o_exc = _a16(o_ac + (4 * header.ac_count if ac_pl else 0))
    n_exc = int(exc_counts.sum())
    o_packed = _a16(o_exc + n_exc)
    n_packed = int(bpr.sum())
    buf = np.empty(o_packed + n_packed, np.uint8)

    f_packed = pool.submit(timing.task("section.ids", _dpk_packed), header,
                           packed_raw, buf[o_packed:])
    f_exc = pool.submit(timing.task("section.ids", _dpk_exceptions), header,
                        exc_z, buf[o_exc : o_exc + n_exc])
    f_dc = (pool.submit(timing.task("section.dc", entropy.decode_float_planes),
                        dz, out=buf[o_dc : o_dc + 4 * nblk].reshape(4, nblk))
            if dc_pl else
            pool.submit(timing.task("section.dc", _float_raw), header, dz, False))
    f_ac = (pool.submit(timing.task("section.ac", entropy.decode_float_planes),
                        az, out=buf[o_ac : o_ac + 4 * header.ac_count].reshape(
                            4, header.ac_count))
            if ac_pl else
            pool.submit(timing.task("section.ac", _float_raw), header, az, False))
    buf[o_width : o_width + rows] = width
    offs = buf[:n_off].view(np.int64)
    for lens, o in ((bpr, 0), (exc_counts, rows + 1), (ac_counts, rows + nc + 2)):
        offs[o] = 0
        np.cumsum(lens, out=offs[o + 1 : o + 1 + lens.size])

    cfg = _header_config(header)
    stored = np.dtype(np.float32)
    extra = []
    if not dc_pl:
        dc_raw = f_dc.result()
        stored, cfg = _stored_dtype(header, len(dc_raw), nblk, cfg)
        extra.append(np.frombuffer(dc_raw, dtype=stored, count=nblk))
    if not ac_pl:
        extra.append(np.frombuffer(f_ac.result(), np.uint8,
                                   header.ac_count * stored.itemsize))
        offs[rows + nc + 2 :] *= stored.itemsize
    for f in (f_packed, f_exc, f_dc, f_ac):
        f.result()
    upload = _Upload(n_stream, tile_b, cw, cfg, nblk, t, nc,
                     _cape_tier(peak_e, cw), _capc_tier(peak_a, cw), stored,
                     dc_pl, ac_pl, header.ac_count, n_off, o_width, o_dc, o_ac,
                     o_exc, n_exc, o_packed, n_packed)
    return (buf, *extra), upload


def _dpk_rows_on_device(dev, up: _Upload):
    """_decode_device_dpk's arrays (width, packed rows, exception rows, DC,
    AC rows) from _dpk_decode_prep's arrays on the device (dev,
    _to_device): kernel N lays out the rows from the tight streams
    (dpk_fuse.dpk_rows_layout: float32 AC rows from the byte planes); DC as
    uploaded (byte planes, or the stored dtype)."""
    from .ops import dpk_fuse

    buf, extra = dev[0], list(dev[1:])
    dc = (buf[up.o_dc : up.o_dc + 4 * up.nblk].view(4, up.nblk) if up.dc_planes
          else extra.pop(0))
    packed_rows, exc_rows, ac_rows = dpk_fuse.dpk_rows_layout(
        *up.layout_args(buf, None if up.ac_planes else extra.pop(0)))
    if not up.ac_planes:
        ac_rows = ac_rows.view(torch.float64 if up.stored == np.float64
                               else torch.float32)
    bs = up.cfg.block_size
    width = buf[up.o_width : up.o_width + up.tiles * bs].view(up.tiles, bs)
    return width, packed_rows, exc_rows, dc, ac_rows


def _decode_dpk_upload(dev, up: _Upload, sf, dcd: bool, qtable=None):
    """The device stage of a whole DPK container from _dpk_decode_prep's
    arrays on the device: kernel N (_dpk_rows_on_device), then
    _decode_device_dpk."""
    return _decode_device_dpk(*_dpk_rows_on_device(dev, up), up.n_stream,
                              up.cfg, up.tile_b, up.cw, sf, dcd, qtable)


def _decode_device_dpk(width, packed_rows, exc_rows, dc, ac_buf, n: int,
                       cfg: CodecConfig, tile_b: int, cw: int, sf, dcd: bool,
                       qtable=None):
    """The device decode of a DPK container's arrays (dctz_tpu/api.py:
    _decode_device_dpk) -> (n,) of sf's dtype. dc/ac_buf may arrive as
    (4, ...) u8 byte planes, reassembled here; qtable (a device tensor)
    selects QT mode. The ids and the AC values come from kernel C where it
    takes the container (dpk_fuse.decode_eligible: tiles of 256 blocks,
    float32 stored values), else from idpack.unpack_ids and qz.expand_ac
    (torch ops at any tile; kernel I at the chunk widths it takes); the
    dequantization and inverse transform run on
    kernel D (float32 at blocks of 64 and 255 bins) or in torch ops of sf's
    dtype (qz.decode_x), as the reference's _decode_core does (_dequantize)."""
    from .ops import dpk_fuse, idpack

    if dc.dtype == torch.uint8:
        dc = _combine_planes(dc)
    if ac_buf.dtype == torch.uint8:
        ac_buf = _combine_planes(ac_buf)
    if dcd:
        dc = _f32_delta_inv_dev(dc)
    ac_buf = ac_buf.contiguous()
    nblk = -(-n // cfg.block_size)
    if (dpk_fuse.decode_eligible(cfg, tile_b, cw)
            and ac_buf.dtype == torch.float32):
        ids, acv = dpk_fuse.dpk_unpack_expand(width, packed_rows, exc_rows,
                                              ac_buf, nblk, n, cw)
    else:
        ids = idpack.unpack_ids(width, packed_rows, exc_rows, nblk,
                                cfg.block_size, tile_b, cw)
        acv = qz.expand_ac(ids, ac_buf, n)
    return _dequantize(ids, acv, dc, n, cfg, sf, qtable)


def _dequantize(ids, acv, dc, n: int, cfg: CodecConfig, sf, qtable):
    """The dequantization and inverse transform of the first n positions
    -> (n,) of sf's dtype: kernel D for float32 at blocks of 64 and 255
    bins, float64 torch ops (qz.decode_x) for a float64 container, float32
    torch ops at any other geometry, as dctz_tpu's XLA decode."""
    from .ops import dpk_fuse

    if sf.dtype == torch.float32 and dpk_fuse.default_geometry(cfg):
        return dpk_fuse.dequant_idct(ids, acv, dc.contiguous(), sf, cfg, n,
                                     qtable)[:n]
    return qz.decode_x(ids, dc, acv, n, cfg, sf, qtable, sf.dtype)[1]


def _work_dtype(header: ct.Header) -> torch.dtype:
    """The decode's arithmetic: the container's own dtype, float64 at full
    width as dctz_tpu's _decode_work_dtype gives on a backend that is not a
    TPU (dctz_tpu/api.py:1581-1600)."""
    return torch.float64 if header.dtype == np.float64 else torch.float32


def _to_device(host_arrays, header: ct.Header, qtable, device):
    """The host stage's arrays, the scaling factor and the qtable on
    `device`, the last two in the decode's dtype (_work_dtype)."""
    device = torch.device(device)
    dev = [timing.to_device(torch.from_numpy(np.require(a, requirements=["C", "W"])),
                            device)
           for a in host_arrays]
    wd = _work_dtype(header)
    sf = timing.scalar(header.scaling_factor, wd, device)
    qt = (timing.to_device(torch.from_numpy(np.array(qtable)).to(wd), device)
          if qtable is not None else None)
    return dev, sf, qt


def _inflate_v2_streams(header: ct.Header, streams):
    """Inflate and de-filter a host-coded v2 container's sections -> (bindex,
    dc, ac) bytes (a copy of dctz_tpu.api._inflate_v2_streams)."""
    if header.ids4:
        packed_z, exc_z, dz, az = streams
        if header.rans:
            from . import native

            packed = native.rans_decompress(b"".join(packed_z))
        else:
            packed = entropy.chunked_inflate(packed_z)
        exc = (entropy.chunked_unzstd(exc_z) if header.zst
               else entropy.chunked_inflate(exc_z))
        # the stream length is self-describing: one exception byte per
        # 15-nibble plus the odd tail byte (if any)
        p = np.frombuffer(packed, np.uint8)
        count15 = int(((p & 15) == 15).sum()) + int(((p >> 4) == 15).sum())
        odd = len(exc) - count15
        bindex = entropy.unpack_ids4(packed, exc, 2 * len(packed) + odd)
    else:
        bz, dz, az = streams
        bindex = entropy.chunked_inflate(bz)
    return (bindex, _decode_float_section(header, dz, dc=True),
            _decode_float_section(header, az))


def _chunk_escape_counts(flat_ids: np.ndarray, cw: int, bs: int) -> np.ndarray:
    """Per-chunk AC counts from the bin_index stream: every block carries
    exactly one DC escape mark (dctz-comp-lib.c:361), so counts = (#ESCAPE
    bytes per chunk) - cw/bs. Split over the entropy thread pool (numpy
    releases the GIL in the compare and the sum), as dctz_tpu does."""
    nc = flat_ids.size // cw
    view = flat_ids.reshape(nc, cw)
    nthreads = min(4, max(1, nc // 64))
    bounds = np.linspace(0, nc, nthreads + 1, dtype=int)
    out = np.empty(nc, np.int32)

    def work(i):
        lo, hi = bounds[i], bounds[i + 1]
        out[lo:hi] = (view[lo:hi] == C.ESCAPE).sum(axis=1, dtype=np.int32)

    list(entropy._pool().map(work, range(nthreads)))
    return out - cw // bs


def _host_coded_prep(header: ct.Header, bindex, dc_raw, ac_raw):
    """Host stage of a v1 or host-coded v2 decode (dctz_tpu/api.py:
    2022-2058): the id stream holds n_stream ids (v1: n; v2 from the fused
    branch: the padded length); a partial last block is padded with DC
    marks, the per-chunk AC counts come from the ids, and the AC stream is
    cut into rows of the smallest capacity tier that holds them. The DC
    section's size gives the stored dtype (_stored_dtype). Returns ((ids
    (nblk, bs) u8, dc (nblk,), ac_rows (nc, capc), both of the stored
    dtype), n_stream, cfg)."""
    cfg = _header_config(header)
    bs = header.block_size
    n_stream = len(bindex)
    nblk = -(-n_stream // bs)
    flat_ids = np.frombuffer(bindex, dtype=np.uint8, count=n_stream)
    pad = nblk * bs - n_stream
    if pad:
        # bin 0 on the padding, and the padded block's DC mark, so that
        # every block of a chunk holds one DC escape for the count below
        flat_ids = np.concatenate([flat_ids, np.zeros(pad, np.uint8)])
        flat_ids.reshape(nblk, bs)[:, 0] = C.ESCAPE
    stored, cfg = _stored_dtype(header, len(dc_raw), nblk, cfg)
    dc = np.frombuffer(dc_raw, dtype=stored, count=nblk)
    ac = np.frombuffer(ac_raw, dtype=stored, count=header.ac_count)
    cw = qz.chunk_width(nblk * bs, bs)
    counts = _chunk_escape_counts(flat_ids, cw, bs)
    capc = _capc_tier(int(counts.max()) if counts.size else 0, cw)
    ac_rows = entropy.pad_row_prefixes(ac, counts, capc, stored)
    return (flat_ids.reshape(nblk, bs), dc, ac_rows), n_stream, cfg


def _host_stage(blob):
    """Host stage of the decode of one container (v1, DPK v2 or host-coded
    v2, float32 or float64; a DTZS frame is one of these): parse, inflate
    and, but for DPK, re-pad (_dpk_decode_prep, whose rows kernel N lays
    out on the device, or _inflate_v2_streams / entropy.inflate_streams and
    _host_coded_prep). Returns (header, qtable,
    host_arrays, decode): decode(dev_arrays, sf, qtable) runs the device
    stage on the arrays moved by _to_device and returns a tensor of the
    container's dtype whose first header.num_elements samples are the data.
    Float32 at the default geometry: kernels C + D for DPK and I + D for the
    others. Float64: C or I move the float32 stored values, then the
    dequantization and the inverse transform run in float64 torch ops
    (qz.decode_x), as dctz_tpu's XLA decode does (dctz_tpu/api.py:123-133);
    full-width (8-byte) stored values and the geometries kernels C and D do
    not take decode in torch ops (_decode_device_dpk, _dequantize). Spans:
    host.parse (the container's layout and its crcs), then host.prep (the
    inflate and, but for DPK, the re-pad)."""
    with timing.span("host.parse", cpu=True, tile=True):
        v2 = ct.detect_format(blob) == "v2"
        if v2:
            header, streams, qtable, _cb = ct.parse_v2(blob)
        else:
            header, bz, dz, az, qtable = ct.parse_v1(blob)
    with timing.span("host.prep", cpu=True, tile=True):
        if v2 and header.dpk:
            host_arrays, up = _dpk_decode_prep(header, streams)

            def decode_dpk(dev, sf, qt):
                return _decode_dpk_upload(dev, up, sf, header.dcd, qt)

            return header, qtable, host_arrays, decode_dpk
        if v2:
            bindex, dc_raw, ac_raw = _inflate_v2_streams(header, streams)
        else:
            bindex, dc_raw, ac_raw = entropy.inflate_streams([bz, dz, az])
        host_arrays, n_stream, cfg = _host_coded_prep(header, bindex, dc_raw,
                                                      ac_raw)

    def decode_host_coded(dev, sf, qt):
        # kernel I puts the float32 AC rows back at the escapes (torch ops
        # at other chunk widths and at full width); kernel D (float32 at the
        # default geometry) or torch ops dequantize and run the IDCT (the
        # rem-point basis for a partial last block)
        ids, dc, ac = dev
        acv = qz.expand_ac(ids, ac, n_stream)
        return _dequantize(ids, acv, dc, n_stream, cfg, sf, qt)

    return header, qtable, host_arrays, decode_host_coded


def decompress(blob: bytes | memoryview, *, timer=None,
               device: str | torch.device = "cuda") -> np.ndarray:
    """Decompress a container of either format (v1, v2 with DPK or
    host-coded ids) or a DTZS stream of them back to a flat numpy array of
    the container's dtype (float32 or float64; a stream's from its
    frames). timer: as compress()'s."""
    device = checked_device(device)
    with timing.using(timer) as timer:
        if bytes(memoryview(blob)[:4]) == b"DTZS":
            # a segmented stream (stream.py): zero-copy frame reads, the
            # output allocated once
            from . import stream

            with timer.stage("pipeline"):
                return stream.decompress_stream_all(stream.MemReader(blob),
                                                    timer=timer, device=device)
        with timer.stage("host"):
            header, qtable, host_arrays, decode = _host_stage(blob)
        with timer.stage("transfer"):
            dev, sf, qt = _to_device(host_arrays, header, qtable, device)
        with timer.stage("device"):
            x = decode(dev, sf, qt)
        with timer.stage("transfer"):
            return timing.to_host(x[:header.num_elements]).numpy()


# ---------------------------------------------------------------------------
# tile-range decode of a DPK container (the multi-rank restore)
# ---------------------------------------------------------------------------


def _dpk_meta(header: ct.Header, streams, *, with_bytes: bool = False):
    """(n_stream, tile_b, cw) from a DPK container's meta section alone
    (dctz_tpu/api.py:1340-1349): a rank picks its tile range before any
    bulk-section work. with_bytes=True appends the decoded meta section,
    for _dpk_host_rebuild's meta=."""
    _side = entropy.chunked_unzstd if header.zst else entropy.chunked_inflate
    meta = _side(streams[3])
    triple = struct.unpack_from(_DPK_META_FMT, meta, 0)
    return triple + (meta,) if with_bytes else triple


def _float_section_range(header: ct.Header, chunks, i0: int, i1: int):
    """Items [i0, i1) of a DC or AC section as ("planes", [plane bytes]),
    decoding only the chunks each plane needs, for a 4-byte-item PLC
    section; other sections decode whole, ("bytes", raw)
    (dctz_tpu/api.py:752-764)."""
    if header.plc and chunks[0][0] == 4:  # directory byte 0 = itemsize
        planes, _isz = entropy.decode_float_planes(chunks, item_range=(i0, i1))
        return ("planes", planes)
    return ("bytes", _decode_float_section(header, chunks))


def _decompress_dpk_range(header: ct.Header, streams, qtable, t0: int, t1: int,
                          meta=None, device: str | torch.device = "cuda") -> np.ndarray:
    """Decode ONLY tiles [t0, t1) of a monolithic DPK container
    (dctz_tpu/api.py:1352-1458), on `device`. The host rebuilds the
    slice's rows (_dpk_host_rebuild tile_range: the bulk packed section
    byte-range-sliced, crc-checked over the chunks it touches when the
    container was parsed with chunk_crcs="defer") and the slice's DC and AC
    items (_float_section_range); the device decodes only the slice's tiles
    (_decode_device_dpk: kernels C + D where they take the container).
    Returns the elements [t0*tile_b*bs, min(t1*tile_b*bs, num_elements)) in
    the container's dtype."""
    (width, rows, exc_rows, dc_chunks, ac_chunks, n_stream, tile_b, cw,
     ac_counts, nblk) = _dpk_host_rebuild(header, streams, tile_range=(t0, t1),
                                          float_planes="skip", meta=meta)
    cfg = _header_config(header)
    bs = header.block_size
    n_chunks = (nblk * bs) // cw
    epc = (tile_b * bs) // cw
    b0, b1 = t0 * tile_b, min(t1 * tile_b, nblk)
    c0, c1 = t0 * epc, min(t1 * epc, n_chunks)
    acum = np.concatenate(([0], np.cumsum(ac_counts, dtype=np.int64)))
    a0, a1 = int(acum[c0]), int(acum[c1])
    dc_kind, dc_dat = _float_section_range(header, dc_chunks, b0, b1)
    ac_kind, ac_dat = _float_section_range(header, ac_chunks, a0, a1)

    stored = np.dtype(np.float32)
    if dc_kind == "bytes":
        stored, cfg = _stored_dtype(header, len(dc_dat), nblk, cfg)
    counts_loc = ac_counts[c0:c1]
    capc = _capc_tier(int(counts_loc.max()) if counts_loc.size else 0, cw)
    if ac_kind == "planes":
        pls = [np.frombuffer(p, np.uint8, a1 - a0) for p in ac_dat]
        ac_rows = entropy.pad_row_prefixes(
            np.concatenate(pls), np.tile(counts_loc, len(pls)), capc, np.uint8
        ).reshape(len(pls), counts_loc.size, capc)
    else:
        ac_loc = np.frombuffer(ac_dat, stored, count=header.ac_count)[a0:a1]
        ac_rows = entropy.pad_row_prefixes(ac_loc, counts_loc, capc, stored)
    if dc_kind == "planes":
        dc_loc = np.stack([np.frombuffer(p, np.uint8, b1 - b0) for p in dc_dat])
    else:
        dc_loc = np.frombuffer(dc_dat, stored, count=nblk)[b0:b1]

    n_lo = t0 * tile_b * bs
    n_loc = min(t1 * tile_b * bs, n_stream) - n_lo
    dev, sf, qt = _to_device((width, rows, exc_rows, dc_loc, ac_rows), header,
                             qtable, checked_device(device))
    x = _decode_device_dpk(*dev, n_loc, cfg, tile_b, cw, sf, header.dcd, qt)
    n_hi = min(t1 * tile_b * bs, header.num_elements)
    return x[: n_hi - n_lo].cpu().numpy()


# ---------------------------------------------------------------------------
# sharded (multi-GPU) paths
# ---------------------------------------------------------------------------


def _gather(parts: list[torch.Tensor]) -> np.ndarray:
    """The shards' outputs, in mesh order, as one host array."""
    return np.concatenate([p.cpu().numpy() for p in parts])


def _pull_shards(enc, dpk: bool):
    """The host copies of a sharded encode's outputs (sharding.Encoded):
    (per shard a dict of numpy arrays, the DC stream, the tight AC stream),
    both streams in mesh order. Each shard's copies start before any is
    waited for."""
    from . import stream

    keys = (("width", "packed", "exc_rows", "exc_counts", "dpk_ac_counts") if dpk
            else ("bin_ids",)) + ("dc", "ac_rows", "ac_counts")
    pulls = [stream._start_pull([s[k] for k in keys]) for s in enc.shards]
    host = [dict(zip(keys, p())) for p in pulls]
    dc = np.concatenate([h["dc"] for h in host])
    ac = np.concatenate([entropy.take_row_prefixes(h["ac_rows"], h["ac_counts"])
                         for h in host])
    return host, dc, ac


def _cat_rows(rows: list[np.ndarray]) -> np.ndarray:
    """Row arrays of the shards stacked; a shard retried at full chunk width
    has wider rows, so the narrower ones are zero-padded to the widest
    (the host keeps row prefixes only)."""
    cap = max(r.shape[1] for r in rows)
    return np.concatenate([np.pad(r, ((0, 0), (0, cap - r.shape[1]))) for r in rows])


def compress_sharded(
    x: Any,
    error_bound: float = 1e-3,
    mode: str = "ec",
    *,
    config: CodecConfig | None = None,
    mesh=None,
    device: str | torch.device = "cuda",
) -> bytes:
    """Compress an array sharded over a device mesh into a v2 container
    (dctz_tpu/api.py:2104-2257). The signature of dctz_tpu's plus `device`:
    mesh (a list of devices, parallel/sharding.make_mesh) wins when given,
    else `device` builds it ("cuda": every visible card). Per-shard work is
    local (parallel/sharding.encode_sharded: kernels A + B per shard for EC
    with the device ids, the chain with kernel H otherwise); only the
    scaling factor, mean, tolerance, flags and QT table reduce across
    shards. The container is forced to v2, brsf snapped, the ids codec
    resolved. Float64 runs at full width unless internal_dtype="float32".
    A tensor is padded and split where it lies (shard_input_device), never
    through the host. The id stream has the padded length n_pad: a multiple
    of len(mesh) * block_size, times the 256-block tile with the device
    ids."""
    from .ops import idpack
    from .parallel import sharding as sh

    cfg = config or CodecConfig(mode=mode, error_bound=error_bound, container="v2")
    if cfg.container != "v2":
        cfg = dataclasses.replace(cfg, container="v2")
    cfg = _resolve_ids_codec(_quantize_brsf(cfg))
    _check_internal_dtype(cfg)
    mesh = sh.mesh_for(mesh, device)
    dpk = cfg.ids_codec == "device"
    quantum = idpack.B_DEFAULT if dpk else 1
    bs = cfg.block_size
    if isinstance(x, torch.Tensor):
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"unsupported dtype {x.dtype}; use float32/float64")
        src_dtype = np.dtype(np.float64 if x.dtype == torch.float64 else np.float32)
        n = x.numel()
        if n == 0:
            raise ValueError("cannot compress an empty array")
        shards, n_pad = sh.shard_input_device(
            x, mesh, bs, quantum,
            promote_f32=src_dtype == np.float64 and cfg.internal_dtype == "float32")
    else:
        src_dtype = np.dtype(getattr(x, "dtype", np.float64))
        arr = np.asarray(x).reshape(-1)
        if arr.dtype not in (np.float32, np.float64):
            raise TypeError(f"unsupported dtype {arr.dtype}; use float32/float64")
        if arr.dtype == np.float64 and cfg.internal_dtype == "float32":
            arr = arr.astype(np.float32)
        n = int(arr.shape[0])
        if n == 0:
            raise ValueError("cannot compress an empty array")
        shards, n_pad = sh.shard_input(arr, mesh, bs, quantum)

    enc = sh.encode_sharded(shards, n_real=n, cfg=cfg, dpk=dpk)
    host, dc, ac = _pull_shards(enc, dpk)
    if enc.ok is not None and not bool(enc.ok):
        _warn_bound()
    qtable = enc.qtable.cpu().numpy() if enc.qtable is not None else None
    header = _header(cfg, n, ac.shape[0], float(enc.sf), float(enc.mean), src_dtype)
    header.shuffle = cfg.shuffle
    dc_ac_z = (
        _float_sections(dc.tobytes(), dc.dtype.itemsize, cfg, header, dc=True),
        _float_sections(ac.tobytes(), ac.dtype.itemsize, cfg, header),
    )
    if dpk:
        # the shards' tile- and chunk-major outputs, in mesh order, ARE the
        # single-device layout
        cat = {k: np.concatenate([h[k] for h in host]) for k in
               ("width", "packed", "exc_counts", "dpk_ac_counts")}
        streams = _dpk_sections(
            cat["width"], cat["packed"], _cat_rows([h["exc_rows"] for h in host]),
            cat["exc_counts"], cat["dpk_ac_counts"], idpack.B_DEFAULT,
            qz.chunk_width(n_pad // len(mesh), bs), n_pad, cfg, header,
        ) + dc_ac_z
    else:
        ids = np.concatenate([h["bin_ids"] for h in host])
        streams = _ids_streams(ids.reshape(-1).tobytes(), cfg, header) + dc_ac_z
    return ct.pack_v2(header, streams, qtable if cfg.mode == "qt" else None,
                      cfg.chunk_bytes)


def _decode_dpk_on(header: ct.Header, streams, qtable, device) -> np.ndarray:
    """The single-device decode of a parsed DPK container on `device`."""
    host_arrays, up = _dpk_decode_prep(header, streams)
    dev, sf, qt = _to_device(host_arrays, header, qtable, device)
    x = _decode_dpk_upload(dev, up, sf, header.dcd, qt)
    return x[:header.num_elements].cpu().numpy()


def _decompress_dpk_sharded(header: ct.Header, streams, qtable, mesh) -> np.ndarray:
    """The sharded decode of a DPK container (dctz_tpu/api.py:1251-1337):
    the host re-pads the tile- and chunk-major layouts to a whole-tile
    multiple of the mesh (zero tiles decode to zero blocks) and every shard
    decodes its own tiles (parallel/sharding.decode_sharded_dpk). A
    container whose stream length is not a block multiple (the XLA chain's
    rem-point tail) decodes on the single-device path of the mesh's first
    device."""
    from .parallel import sharding as sh

    (width, rows, exc_rows, dc_raw, ac_raw, n_stream, tile_b, cw, ac_counts,
     nblk) = _dpk_host_rebuild(header, streams, float_planes=False)
    cfg = _header_config(header)
    bs = header.block_size
    n_dev = len(mesh)
    if n_stream % bs:
        return _decode_dpk_on(header, streams, qtable, mesh[0])
    stored, cfg = _stored_dtype(header, len(dc_raw), nblk, cfg)
    dc = np.frombuffer(dc_raw, dtype=stored, count=nblk)
    if header.dcd:  # the shards take DC values, not deltas
        dc = entropy.f32_delta_inv(dc)
    ac = np.frombuffer(ac_raw, dtype=stored, count=header.ac_count)
    capc = _capc_tier(int(ac_counts.max()) if ac_counts.size else 0, cw)
    ac_rows = entropy.pad_row_prefixes(ac, ac_counts, capc, stored)

    tpd = -(-width.shape[0] // n_dev) * n_dev
    epc = tile_b * bs // cw

    def _pad_rows(a: np.ndarray, want: int) -> np.ndarray:
        if a.shape[0] == want:
            return a
        pad = np.zeros((want - a.shape[0],) + a.shape[1:], a.dtype)
        return np.concatenate([a, pad])

    parts = sh.decode_sharded_dpk(
        _pad_rows(width, tpd), _pad_rows(rows, tpd * bs), _pad_rows(exc_rows, tpd * epc),
        _pad_rows(dc, tpd * tile_b), _pad_rows(ac_rows, tpd * epc),
        header.scaling_factor, qtable, tile_b=tile_b, cw=cw, cfg=cfg,
        dtype=_work_dtype(header), mesh=mesh)
    return _gather(parts)[:header.num_elements]


def decompress_sharded(blob: bytes | memoryview, *, mesh=None,
                       device: str | torch.device = "cuda") -> np.ndarray:
    """Decompress a v2 container (or a DTZS stream of them) with the device
    stage sharded over a mesh (dctz_tpu/api.py:2260-2375); mesh and device
    as in compress_sharded. DPK containers: _decompress_dpk_sharded.
    Host-coded ones: the host inflates the streams, pads the id stream to
    the mesh quantum (bin 0 and a DC mark on the padding, which decodes to
    zero blocks), cuts the AC stream into chunk rows by the per-chunk
    escape counts of the ids, and every shard decodes its rows
    (parallel/sharding.decode_sharded: kernels I + D where they apply). An
    id stream whose length is not a block multiple (the generic chain's
    rem-point tail) decodes on the single-device path of the mesh's first
    device, as the DPK branch does. A DTZS stream restores frame by frame
    into one output."""
    from .parallel import sharding as sh

    mesh = sh.mesh_for(mesh, device)
    if bytes(memoryview(blob)[:4]) == b"DTZS":
        from . import stream as _stream

        reader = _stream.MemReader(blob)
        total = _stream._read_stream_header(reader)
        out: np.ndarray | None = None
        off = 0
        while True:
            raw = reader.read(_stream._FRAME.size)
            if len(raw) != _stream._FRAME.size:
                raise ValueError("truncated stream: missing frame header")
            (length,) = _stream._FRAME.unpack(raw)
            if not length:
                break
            body = reader.read(length)
            if len(body) != length:
                raise ValueError("truncated stream: frame body cut short")
            part = decompress_sharded(body, mesh=mesh)
            if out is None:
                if part.size == total:
                    return part
                out = _stream.alloc_output(total, part.dtype)
            out[off : off + part.size] = part
            off += part.size
        if out is None or off != total:
            raise ValueError(f"truncated stream: {off} of {total} elements restored")
        return out

    header, streams, qtable, _cb = ct.parse_v2(blob)
    qtable = qtable if header.mode == "qt" else None
    if header.dpk:
        return _decompress_dpk_sharded(header, streams, qtable, mesh)
    bindex, dc_raw, ac_raw = _inflate_v2_streams(header, streams)
    bs = header.block_size
    n_dev = len(mesh)
    if len(bindex) % bs:
        return decompress(blob, device=mesh[0])

    cfg = _header_config(header)
    ids = np.frombuffer(bindex, np.uint8)
    nblk_real = len(ids) // bs
    n_pad = sh.padded_size(len(ids), n_dev, bs)
    padded = n_pad != len(ids)
    if padded:
        ids = np.concatenate([ids, np.zeros(n_pad - len(ids), np.uint8)])
    nblk = n_pad // bs
    ids2d = ids.reshape(nblk, bs)
    stored, cfg = _stored_dtype(header, len(dc_raw), nblk_real, cfg)
    dc = np.zeros(nblk, stored)
    dc[:nblk_real] = np.frombuffer(dc_raw, stored, count=nblk_real)
    ac = np.frombuffer(ac_raw, stored, count=header.ac_count)
    if padded:
        # a DC mark on every block, so that each chunk's escape count
        # holds one per block (the real blocks have theirs)
        ids2d[:, 0] = C.ESCAPE
    cw = qz.chunk_width(n_pad // n_dev, bs)
    counts = _chunk_escape_counts(ids2d.reshape(-1), cw, bs)
    capc = _capc_tier(int(counts.max()) if counts.size else 0, cw)
    ac_rows = entropy.pad_row_prefixes(ac, counts, capc, stored)
    parts = sh.decode_sharded(ids2d, dc, ac_rows, header.scaling_factor, qtable,
                              cfg=cfg, dtype=_work_dtype(header), mesh=mesh)
    return _gather(parts)[:header.num_elements]
