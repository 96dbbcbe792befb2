"""Segmented compression into the DTZS stream container (port of
dctz_tpu/stream.py).

A stream is a sequence of independent v2 containers behind a small frame
header:

    b"DTZS" | u16 version | u16 reserved | u64 total_elements
    repeat: u64 frame_len | v2 container bytes
    u64 0  (end marker)

A first pass computes the GLOBAL statistics (the scaling factor must see the
whole array; the verify tolerance is eb times the whole array's range), and
in QT mode the GLOBAL quantizer table (the per-position column max over
every segment, max-reduced). Each segment is then encoded with those fixed
values. Segments are block multiples, so DCT blocks never cross a frame.
Two segment paths, chosen as the JAX package chooses them (its dpk_seg):

  DPK (ids_codec "device", or "auto", which means it for v2): the same
    kernels as the monolithic path (A + B, ops/dpk_fuse.encode_x_fused; E
    for the qtable) and the same host packer (api._pack_dpk_v2). A stream
    decodes bit-identically to the monolithic container of the same data
    whenever the segment size is a multiple of the 1024-element pad quantum
    (the default DEFAULT_SEGMENT is).
  generic (every other configuration: v1 with an int segment_elems, the ids
    codecs "deflate", "rans" and, for v1, "auto", a block size other than
    64, a bin count other than 255, truncate=False, and every float64
    array, whose frames are float64 containers): the generic chain
    (_encode_segment: the transform, bins and verify-repair as torch ops,
    the compaction in kernel H; _qtable_colmax_segment for the qtable) and
    a host-coded v2 frame (_pack_segment), whatever the config's container.
    These frames decode through kernels I and D (float32 at the default
    geometry), or kernel I and torch ops (float64, and other geometries;
    full-width streams in torch ops alone).

Both directions run a two-stage pipeline: the writer's host worker pulls and
packs segment k (its device-to-host copies run on a side CUDA stream) while
the device encodes segment k + 1; the reader's host worker re-inflates frame
k + 1 while the device decodes frame k. Besides the input, the device holds
at most two segments in flight.
"""


from __future__ import annotations

import concurrent.futures
import struct
import time
from typing import BinaryIO, Iterator

import numpy as np
import torch

from .config import CodecConfig
from .core import container as ct
from .core import quantize as qz

MAGIC = b"DTZS"
_HDR = struct.Struct("<4sHHQ")
_FRAME = struct.Struct("<Q")

DEFAULT_SEGMENT = 1 << 24  # 16Mi elements per segment
#: compress() segments v2 EC/QT arrays at or above this element count
#: (cfg.segment_elems="auto"): two DEFAULT_SEGMENT frames are the least for
#: the device and host stages to overlap at all.
AUTO_THRESHOLD = 2 * DEFAULT_SEGMENT
_PAD_QUANTUM = 1024  # the fused encode pads to whole (8, 128) tiles


def _stats_stream_device(x: torch.Tensor):
    """Global statistics of a device-resident array, reduced on its device:
    (max|x|, sum, max, min) as tensors. max|x| = max(|max|, |min|) exactly;
    the sum is a sum in the array's dtype, as the JAX package's device
    branch takes it (dctz_tpu/stream.py:_stats_stream_device), equal to it
    up to the order of the additions."""
    vmin, vmax = torch.aminmax(x)
    amax = torch.maximum(torch.abs(vmax), torch.abs(vmin))
    return amax, torch.sum(x), vmax, vmin


def _stats_stream_host(x: np.ndarray, segment_elems: int):
    """The same statistics of a host array, one segment at a time (python
    floats): the array is never copied whole. The sum adds float64 segment
    sums, as the JAX package's host branch does (dctz_tpu/stream.py:187-192),
    so the two write the same mean."""
    amax, total, vmax, vmin = 0.0, 0.0, -np.inf, np.inf
    for seg in _segments(x, segment_elems):
        amax = max(amax, float(np.abs(seg).max()))
        total += float(seg.sum(dtype=np.float64))
        vmax = max(vmax, float(seg.max()))
        vmin = min(vmin, float(seg.min()))
    return amax, total, vmax, vmin


def _segments(x, segment_elems: int) -> Iterator:
    """Slices of `x` (numpy, or a tensor: device slices never leave it)."""
    for off in range(0, x.shape[0], segment_elems):
        yield x[off : off + segment_elems]


def _on_device(seg, device: torch.device, pad: bool = True) -> torch.Tensor:
    """A segment as a tensor of its dtype on `device`, zero-padded to the
    tile quantum unless pad is False (the generic chain takes it
    unpadded)."""
    if isinstance(seg, np.ndarray):
        if not seg.flags.writeable:
            seg = seg.copy()
        seg = torch.from_numpy(seg)
    seg = seg.to(device)
    extra = (-seg.shape[0]) % _PAD_QUANTUM if pad else 0
    return torch.nn.functional.pad(seg, (0, extra)) if extra else seg


def _start_pull(tensors):
    """Start copying device tensors (or None) to the host. Returns a
    function that waits for the copies and returns them as numpy arrays. On
    a CUDA device the copies run on a side stream into pinned memory, so the
    next segment's kernels run meanwhile."""
    live = [t for t in tensors if t is not None]
    dev = live[0].device
    if dev.type != "cuda":
        arrays = [None if t is None else t.numpy() for t in tensors]
        return lambda: arrays
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    host = []
    with torch.cuda.stream(side):
        for t in tensors:
            if t is None:
                host.append(None)
                continue
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t.record_stream(side)
            host.append(h)
    done = torch.cuda.Event()
    done.record(side)

    def wait():
        done.synchronize()
        return [None if h is None else h.numpy() for h in host]

    return wait


def compress_stream(
    x,
    out: BinaryIO,
    *,
    config: CodecConfig,
    segment_elems: int = DEFAULT_SEGMENT,
    trace: list | None = None,
    device: str | torch.device = "cuda",
) -> int:
    """Compress the flat float32 or float64 array `x` into `out` as a DTZS
    stream of frames of segment_elems elements (rounded down to a block
    multiple): DPK v2 frames for ids_codec "device" on float32 data,
    host-coded v2 frames of the generic chain otherwise, of the array's
    dtype (float64 at full width: internal_dtype does not apply here, as in
    the reference, whose compress() casts before calling its writer).
    Returns the bytes written.

    x: a numpy array (statistics on the host, one segment at a time; each
    segment then goes to `device`) or a tensor (moved to `device` once;
    statistics reduce there and the segments are slices of it).
    trace: an optional list collecting per-segment wall times
    ("device" | "pull" | "pack", segment, t0, t1)."""
    from . import api
    from .ops import dpk_fuse
    from .ops import fused_encode as fe
    from .ops.repair import _SLACK

    cfg = config
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
    if isinstance(x, torch.Tensor):
        x = x.reshape(-1)
        dtype = np.dtype(str(x.dtype).removeprefix("torch."))
    else:
        x = np.asarray(x).reshape(-1)
        dtype = x.dtype
    if dtype not in (np.float32, np.float64):
        raise TypeError(f"unsupported dtype {dtype}; use float32/float64")
    n = int(x.shape[0])
    if n == 0:
        raise ValueError("cannot compress an empty array")
    cfg = api._resolve_ids_codec(cfg)
    api._check_internal_dtype(cfg)
    # the JAX writer's dpk_seg (dctz_tpu/stream.py:227-238): DPK frames on
    # kernels A + B for the device ids on float32 data at their geometry
    # (blocks of 64, 255 bins) with truncate on, at any brsf (an operand of
    # A). Everything else writes host-coded frames; a float64 array with
    # the device ids among them, whose ids take Huffman-only deflate
    # (api._ids_streams)
    dpk_seg = (cfg.ids_codec == "device" and cfg.mode in ("ec", "qt")
               and dtype == np.float32 and cfg.truncate
               and dpk_fuse.default_geometry(cfg))
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    bs = cfg.block_size
    segment_elems = max(bs, segment_elems - segment_elems % bs)

    # pass 1: global statistics
    if isinstance(x, torch.Tensor):
        x = x.to(device)
        amax_d, total_d, vmax_d, vmin_d = _stats_stream_device(x)
        amax = amax_d
        total, vmax, vmin = float(total_d), float(vmax_d), float(vmin_d)
    else:
        amax, total, vmax, vmin = _stats_stream_host(x, segment_elems)
        amax = torch.tensor(amax, dtype=tdtype, device=device)
    from .core.stats import scaling_factor

    sf_t = scaling_factor(amax, cfg.sf_adj)
    sf = float(sf_t)
    # the header's mean is total / n in doubles, unrounded, as the JAX
    # writer stores it (dctz_tpu/stream.py:200); total is a float32 sum on
    # the device route and a float64 sum of segment sums on the host route,
    # so the two routes store different means, as the JAX package's do
    mean = total / n
    # the verify tolerance is GLOBAL (eb times the range of the whole
    # array), computed in python doubles and rounded once to the segment
    # dtype, as the JAX stream writer does
    tol_t = torch.tensor((vmax - vmin) * cfg.error_bound * _SLACK,
                         dtype=tdtype, device=device)

    # QT: the global column max over every segment first, max-reduced (max
    # is associative: equal to the whole-array pass): kernel E on DPK
    # segments, _qtable_colmax_segment on generic ones; frames store it
    # clamped, with slot 0 patched to their own last block's DC
    qt_ext = None
    if cfg.mode == "qt":
        for seg in _segments(x, segment_elems):
            if dpk_seg:
                q1 = fe.qtable_qmax(_on_device(seg, device), sf_t, cfg.error_bound,
                                    relaxed=api._relaxed(cfg), brsf=cfg.brsf)
            else:
                q1 = _qtable_colmax_segment(_on_device(seg, device, pad=False),
                                            int(seg.shape[0]), sf_t, cfg)
            qt_ext = q1 if qt_ext is None else torch.maximum(qt_ext, q1)

    def write_frame(blob: bytes) -> int:
        out.write(_FRAME.pack(len(blob)))
        out.write(blob)
        return _FRAME.size + len(blob)

    written = _HDR.size
    out.write(_HDR.pack(MAGIC, 1, 0, n))
    bound_bad: list[int] = []  # segments where repair fell short
    with concurrent.futures.ThreadPoolExecutor(1) as host_worker:
        pending = None
        for si, seg in enumerate(_segments(x, segment_elems)):
            t0 = time.perf_counter()
            n_seg = int(seg.shape[0])
            # each segment's device stage blocks on its overflow flag, so
            # this interval covers the segment's device work
            if dpk_seg:
                xs = _on_device(seg, device)
                outs, planes, qt_seg = _encode_segment_dpk(xs, n_seg, sf_t, tol_t,
                                                           cfg, qt_ext)
                pull = _start_pull(_pull_list(outs, planes, qt_seg, cfg))
                pack = (_pack_segment_dpk, pull, planes is not None, n_seg,
                        int(xs.shape[0]), sf, mean, cfg)
            else:
                q, ok = _encode_segment(_on_device(seg, device, pad=False), n_seg,
                                        sf_t, tol_t, cfg, qt_ext)
                pull = _start_pull([q.bin_ids, q.dc, q.ac_buf, q.ac_count,
                                    q.qtable, ok])
                pack = (_pack_segment, pull, n_seg, sf, mean, cfg, dtype)
            if trace is not None:
                trace.append(("device", si, t0, time.perf_counter()))
            if pending is not None:
                written += write_frame(pending.result())
            pending = host_worker.submit(*pack, bound_bad, si, trace)
        written += write_frame(pending.result())
    out.write(_FRAME.pack(0))
    _warn_bound(bound_bad)
    return written + _FRAME.size


def _warn_bound(bound_bad: list) -> None:
    if bound_bad:
        import warnings

        warnings.warn(
            "verify-repair could not fully satisfy the pointwise bound in "
            f"segment(s) {bound_bad} (float32-truncation floor)",
            stacklevel=3,
        )


def _encode_segment_dpk(xs: torch.Tensor, n: int, sf_t: torch.Tensor,
                        tol_t: torch.Tensor, cfg: CodecConfig, qt_ext,
                        src_dtype=np.float32):
    """Device stage of one DPK array: kernels A + B with the given sf,
    tolerance and qtable, retried once at full chunk width on exception
    overflow (the qtable does not depend on the width, so E is not rerun);
    cfg.dct_precision "high" takes A's RELAXED instantiation, and cfg.brsf
    reaches A as its bin geometry.
    xs: the array on its device, zero-padded to the 1024 tile quantum
    (_on_device), n of its samples real. The float32 DC/AC streams are
    split into byte planes on the device (api._plane_split2) so the host
    packer skips its shuffle; with cfg.dc_delta on a v2 config the DC
    stream is delta-coded first (dctz_tpu/stream.py:393-397), unless the
    container declares float64 (src_dtype, internal_dtype="float32"), which
    keeps raw DC as api._dcd_on says. qt_seg: the
    qtable with slot 0 set to the last REAL block's DC, un-delta'd. Returns
    (outs, planes, qt_seg). The monolithic container is the one-segment
    case (api._compress_fused)."""
    from . import api
    from .ops import dpk_fuse, idpack
    from .ops.fused_encode import patch_slot0

    cw = qz.chunk_width(int(xs.shape[0]), cfg.block_size)

    def encode(cape):
        return dpk_fuse.encode_x_fused(xs, sf_t, tol_t, n, cfg.error_bound,
                                       min(cape, cw), cw, cfg.verify, qt_ext,
                                       relaxed=api._relaxed(cfg),
                                       brsf=cfg.brsf)

    outs = encode(idpack.CAPE)
    if bool(outs[7]):
        outs = encode(cw)
    qt_seg = patch_slot0(qt_ext, outs[6], n) if qt_ext is not None else None
    dcd = (cfg.dc_delta and cfg.container == "v2"
           and np.dtype(src_dtype) == np.float32)
    planes = (api._plane_split2(outs[6], outs[4], dcd)
              if api._plane_mode(cfg, outs[6]) else None)
    return outs, planes, qt_seg


def _pull_list(outs, planes, qt_seg, cfg: CodecConfig):
    """What the host packer needs of a segment's device outputs: width,
    packed, exc_rows, exc_counts, ac_counts, then (dc, ac) or their byte
    planes, the verify flag and the qtable (None where absent)."""
    width, packed, exc_rows, exc_counts, ac, ac_counts, dc, _ovf, ok = outs
    dc_s, ac_s = planes if planes is not None else (dc, ac)
    return [width, packed, exc_rows, exc_counts, ac_counts, dc_s, ac_s,
            ok if cfg.verify else None, qt_seg]


def _pack_segment_dpk(pull, plane_mode: bool, n: int, n_pad: int, sf: float,
                      mean: float, cfg: CodecConfig,
                      bound_bad: list | None = None, seg_index: int = 0,
                      trace=None, dtype=np.float32) -> bytes:
    """Host stage of one DPK segment (on the writer's worker thread, or on
    the caller's for a monolithic container): wait for the segment's copies
    (the "pull" interval: device completion plus transfer) and pack the
    same v2 container the monolithic path emits (the "pack" interval, host
    CPU only). dtype: the header's, float64 for a monolithic float64 array
    cast by internal_dtype="float32"."""
    from . import api

    tp0 = time.perf_counter()
    (width, packed, exc_rows, exc_counts, counts, dc_s, ac_s, ok,
     qtable) = pull()
    if ok is not None and bound_bad is not None and not bool(ok):
        bound_bad.append(seg_index)
    header = api._header(cfg, n, int(counts.sum()), sf, mean, dtype)
    tp1 = time.perf_counter()
    planes = dict(dc_planes=dc_s, ac_planes=ac_s) if plane_mode else {}
    blob = api._pack_dpk_v2(
        header, width, packed, exc_rows, exc_counts, counts,
        None if plane_mode else ac_s, None if plane_mode else dc_s, n_pad,
        cfg, qtable, **planes,
    )
    if trace is not None:
        trace.append(("pull", seg_index, tp0, tp1))
        trace.append(("pack", seg_index, tp1, time.perf_counter()))
    return blob


def _qtable_colmax_segment(xs: torch.Tensor, n: int, sf_t: torch.Tensor,
                           cfg: CodecConfig) -> torch.Tensor:
    """QT pass 1 of one generic segment (dctz_tpu/stream.py:97-119): the
    per-position max |escaped AC coefficient| of the forward transform at
    cfg.dct_precision, unclamped, slot 0 zero (qz.escape_colmax). xs: the
    segment on its device, unpadded, n its length. Torch ops, as the JAX
    package leaves this to XLA."""
    from . import api

    coeffs = api._forward_padded(xs / sf_t, cfg.block_size, cfg.dct_precision)
    return qz.escape_colmax(coeffs, n, cfg)


def _quantize_segment(xs: torch.Tensor, n: int, sf_t: torch.Tensor, tol_t,
                      cfg: CodecConfig, qt_ext: torch.Tensor | None = None):
    """The generic chain up to the stored values (dctz_tpu/stream.py:65-94,
    and api._encode_device for a whole array), in the dtype of xs: x / sf,
    the forward transform at cfg.dct_precision (a rem-point tail when the
    array ends mid-block), bins (QT: the qtable of qt_ext, the writer's
    global column max, else of these coefficients), and the verify-repair
    against tol_t when cfg.verify. xs: the array on its device, unpadded,
    n its length; tol_t: the tolerance tensor of its dtype (None without
    verify). Torch ops, as the JAX package leaves them to XLA. Returns (bin
    ids int32 (nblk, bs), dc of the stored dtype (qz.stored_dtype: float32,
    or the dtype of xs with truncate off), stored values (nblk, bs) in the
    dtype of xs, qtable or None, ok or None)."""
    from . import api
    from .ops import repair

    bs = cfg.block_size
    coeffs = api._forward_padded(xs / sf_t.to(xs.dtype), bs, cfg.dct_precision)
    ids, dc, vals, qtable = qz.quantize(coeffs, n, cfg, qt_ext)
    ok = None
    if cfg.verify:
        ids, ok = repair.verify_repair(xs, coeffs, sf_t, ids, dc, n, n, cfg,
                                       tol_t, qtable)
        acm = qz.ac_mask(coeffs.shape[0], bs, n, xs.device)
        vals = repair.stored_dense(coeffs, ids, acm, cfg, qtable)
    return ids, dc, vals, qtable, ok


def _encode_segment(xs: torch.Tensor, n: int, sf_t: torch.Tensor, tol_t,
                    cfg: CodecConfig, qt_ext: torch.Tensor | None = None):
    """Device stage of one array on the generic chain: _quantize_segment,
    then the compaction of the stored values (qz.repack: kernel H on the
    card for float32 rows of a width it takes, torch ops otherwise). On a row overflow only the compaction is rerun at full
    chunk width, where the JAX writer reruns the whole segment: the width
    changes nothing but the compaction, so the streams are the same.
    Returns (qz.Quantized, ok or None)."""
    ids, dc, vals, qtable, ok = _quantize_segment(xs, n, sf_t, tol_t, cfg,
                                                  qt_ext)
    return qz.repack(ids, vals, dc, qtable, n, cfg), ok


def _pack_segment(pull, n: int, sf: float, mean: float, cfg: CodecConfig,
                  dtype=np.float32, bound_bad: list | None = None,
                  seg_index: int = 0, trace=None) -> bytes:
    """Host stage of one generic segment (dctz_tpu/stream.py:467-516, byte
    for byte): a host-coded v2 frame of `dtype` whatever cfg.container
    says. The id sections of the n real ids (api._ids_streams); DC and AC
    (float32, or 8-byte items at full width) always shuffled (cfg.shuffle)
    and chunk-deflated, never plane-coded; the DC delta (cfg.dc_delta) on
    the host for a float32 frame (a float64 frame keeps raw DC); the qtable
    stored in QT mode only."""
    from . import api
    from .core import entropy

    tp0 = time.perf_counter()
    ids, dc, ac_rows, counts, qtable, ok = pull()
    if ok is not None and bound_bad is not None and not bool(ok):
        bound_bad.append(seg_index)
    tp1 = time.perf_counter()
    header = api._header(cfg, n, int(counts.sum()), sf, mean, dtype)
    ac = entropy.take_row_prefixes(ac_rows, counts)
    header.shuffle = cfg.shuffle
    if cfg.dc_delta and dtype == np.float32 and dc.dtype == np.float32:
        # frames restart at their own item 0, so each decodes on its own
        dc = entropy.f32_delta(dc)
        header.dcd = True
    dcb, acb = dc.tobytes(), ac.tobytes()
    if cfg.shuffle:
        dcb = entropy.shuffle_bytes(dcb, dc.dtype.itemsize)
        acb = entropy.shuffle_bytes(acb, ac.dtype.itemsize)
    streams = api._ids_streams(ids.reshape(-1)[:n].tobytes(), cfg, header) + (
        entropy.chunked_deflate(dcb, cfg.chunk_bytes, cfg.zlib_level),
        entropy.chunked_deflate(acb, cfg.chunk_bytes, cfg.zlib_level),
    )
    blob = ct.pack_v2(header, streams, qtable if cfg.mode == "qt" else None,
                      cfg.chunk_bytes)
    if trace is not None:
        trace.append(("pull", seg_index, tp0, tp1))
        trace.append(("pack", seg_index, tp1, time.perf_counter()))
    return blob


class MemReader:
    """A minimal file-like reader over a buffer: read() returns zero-copy
    memoryview slices, so restoring a DTZS stream held in memory never
    duplicates the blob."""

    def __init__(self, buf) -> None:
        self._mv = memoryview(buf)
        self._pos = 0

    def read(self, size: int) -> memoryview:
        view = self._mv[self._pos : self._pos + size]
        self._pos += len(view)
        return view


def _read_stream_header(f) -> int:
    """Validate the DTZS magic and version; returns total_elements."""
    hdr = bytes(f.read(_HDR.size))
    if len(hdr) != _HDR.size:
        raise ValueError("truncated stream: missing stream header")
    magic, version, _res, total = _HDR.unpack(hdr)
    if magic != MAGIC:
        raise ValueError("not a DCTZ-TPU stream")
    if version != 1:
        raise ValueError(f"unsupported stream version {version}")
    return total


def decompress_stream(f: BinaryIO, trace: list | None = None,
                      device: str | torch.device = "cuda") -> Iterator[np.ndarray]:
    """Yield the reconstructed segments in order (the bounded-memory restore
    path: peak incremental memory is about one segment). A worker thread
    runs frame k + 1's host stage (crc parse, side-stream inflation, row
    re-padding) while this thread runs frame k's device stage. `trace`
    collects ("prep" | "device", frame, t0, t1) wall times."""
    _read_stream_header(f)
    for n, dtype, run in _frame_stages(f, trace, torch.device(device)):
        yield run(np.empty(n, dtype))


def _frame_stages(f, trace, device: torch.device):
    """Yield (n, dtype, run) per frame in order: its element count and
    dtype, and the function that runs its device stage on the caller's
    thread and writes the frame's n samples into a given array (which it
    returns).
    Frame k + 1's host stage is already running on a worker when frame k is
    yielded."""
    from . import api

    def read_frame():
        raw = bytes(f.read(_FRAME.size))
        if len(raw) != _FRAME.size:
            raise ValueError("truncated stream: missing frame header")
        (length,) = _FRAME.unpack(raw)
        if not length:
            return None
        body = f.read(length)
        if len(body) != length:
            raise ValueError("truncated stream: frame body cut short")
        return body

    def prep(blob, fi):
        """Host stage of one frame (api._host_stage: a DPK v2, host-coded
        v2 or v1 container)."""
        t0 = time.perf_counter()
        header, qtable, host_arrays, decode = api._host_stage(blob)
        n = header.num_elements
        if trace is not None:
            trace.append(("prep", fi, t0, time.perf_counter()))

        def run(dst: np.ndarray) -> np.ndarray:
            t1 = time.perf_counter()
            dev, sf, qt = api._to_device(host_arrays, header, qtable, device)
            x = decode(dev, sf, qt)
            torch.from_numpy(dst).copy_(x[:n])  # straight into the output
            if trace is not None:
                trace.append(("device", fi, t1, time.perf_counter()))
            return dst

        return n, header.dtype, run

    with concurrent.futures.ThreadPoolExecutor(1) as host_worker:
        blob = read_frame()
        if blob is None:
            return
        fi = 0
        fut = host_worker.submit(prep, blob, fi)
        while True:
            nxt = read_frame()
            stage = fut.result()
            if nxt is not None:
                fut = host_worker.submit(prep, nxt, fi + 1)
            yield stage
            fi += 1
            if nxt is None:
                return


def decompress_stream_all(f: BinaryIO, trace: list | None = None,
                          device: str | torch.device = "cuda") -> np.ndarray:
    """Reassemble the whole array from a stream into one output buffer,
    allocated once from the stream header's element count and the first
    frame's dtype (dctz_tpu/stream.py:653); each frame's device stage writes
    its samples straight into it (peak incremental memory beyond the output
    is about one segment)."""
    total = _read_stream_header(f)
    out = None
    off = 0
    for n, dtype, run in _frame_stages(f, trace, torch.device(device)):
        if out is None:
            out = np.empty(total, dtype)
        if off + n > total:
            raise ValueError(f"stream frames hold more than its {total} "
                             f"elements")
        run(out[off : off + n])
        off += n
    if out is None or off != total:
        raise ValueError(f"truncated stream: {off} of {total} elements restored")
    return out
