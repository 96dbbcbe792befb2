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
    for the qtable) and the same host packer (api._dpk_v2_streams). A stream
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

The writer runs a two-stage pipeline: its host worker pulls and packs
segment k (its device-to-host copies run on a side CUDA stream) while the
device encodes segment k + 1. Besides the input, the device holds at most
two segments in flight.

The reader runs three stages: prep workers re-inflate frames k + 1 and
k + 2 (crc parse, side-stream inflation into one upload buffer; a DPK
frame's rows are laid out on the device by kernel N; PREP_AHEAD; the CPU
device preps frame k + 1 alone) while the caller uploads and decodes
frame k on the device; on a CUDA device a copy worker meanwhile fills the
output with frame k - 1 (_StagedCopies). The caller copies each decoded frame on
a side stream into one of two pinned staging buffers, which the copy
worker then copies into the output on FILL_THREADS threads; before a
frame reuses a buffer the caller waits for the copy of the frame two
back. So beside the frame being decoded at most two frames' device
outputs and two pinned frames are in flight. decompress_stream, which
yields each segment whole, waits for each copy before the next frame. On
the CPU device the caller copies each frame straight into the output.

Tracing (utils/timing): the writer and the readers take `timer=`. The
writer's thread opens pipeline.stats, pipeline.qtable, pipeline.encode,
pipeline.wait and pipeline.write, one after another, and its worker
pack.pull and pack.host; the readers' thread opens pipeline.wait,
pipeline.decode and copy_out (its own time blocked on the output copy:
the copy itself on the CPU device; the enqueue, the waits for a staging
buffer and the final drain on a CUDA device), their prep workers prep
and their copy worker copy_out.host. A frame's spans carry its index.
"""


from __future__ import annotations

import collections
import concurrent.futures
import struct
from typing import BinaryIO, Iterator

import numpy as np
import torch

from .config import CodecConfig
from .core import container as ct
from .core import quantize as qz
from .utils import timing

MAGIC = b"DTZS"
_HDR = struct.Struct("<4sHHQ")
_FRAME = struct.Struct("<Q")

DEFAULT_SEGMENT = 1 << 24  # 16Mi elements per segment
#: compress() segments v2 EC/QT arrays at or above this element count
#: (cfg.segment_elems="auto"): two DEFAULT_SEGMENT frames are the least for
#: the device and host stages to overlap at all.
AUTO_THRESHOLD = 2 * DEFAULT_SEGMENT
_PAD_QUANTUM = 1024  # the fused encode pads to whole (8, 128) tiles
#: threads that copy a staged frame into the reader's output: a copy into
#: fresh pages is bound by their first-touch faults, which split across
#: threads (a 16Mi float32 frame in 13.4 ms on four threads against 35-37
#: ms on one, on the 8 cores of an H100 host; PERF.md §6)
FILL_THREADS = 4
#: frames whose host stage (the reader's prep) runs at once on a CUDA
#: device, each on its own worker, while the caller decodes the frame
#: before them: one prep takes longer than a frame's decode and staged
#: copy (PERF.md §6)
PREP_AHEAD = 2


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
    seg = timing.to_device(seg, device)
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
    timing.count("bytes_d2h_pinned", sum(t.nbytes for t in live))

    def wait():
        # the side stream holds only these copies
        timing.wait(side)
        return [None if h is None else h.numpy() for h in host]

    return wait


def compress_stream(
    x,
    out: BinaryIO,
    error_bound: float = 1e-3,
    mode: str = "ec",
    *,
    config: CodecConfig | None = None,
    segment_elems: int = DEFAULT_SEGMENT,
    timer=None,
    device: str | torch.device = "cuda",
) -> int:
    """Compress the flat float32 or float64 array `x` into `out` as a DTZS
    stream of frames of segment_elems elements (rounded down to a block
    multiple): DPK v2 frames for ids_codec "device" on float32 data,
    host-coded v2 frames of the generic chain otherwise, of the array's
    dtype (float64 at full width: internal_dtype does not apply here, as in
    the reference, whose compress() casts before calling its writer).
    Returns the bytes written. Without a config, CodecConfig(mode=mode,
    error_bound=error_bound, container="v2"), as dctz_tpu's writer.

    x: a numpy array (statistics on the host, one segment at a time; each
    segment then goes to `device`) or a tensor (moved to `device` once;
    statistics reduce there and the segments are slices of it).
    timer: a utils.timing.StageTimer that takes the writer's spans (module
    docstring) and counters."""
    with timing.using(timer) as t:
        return _write_stream(x, out, config or CodecConfig(
            mode=mode, error_bound=error_bound, container="v2"),
            segment_elems, t, device)


def _write_stream(x, out: BinaryIO, cfg: CodecConfig, segment_elems: int, t,
                  device) -> int:
    """compress_stream's body, traced into t. The writer's thread runs its
    spans one after another, so that they tile the call."""
    with t.span("pipeline.stats", tile=True):
        from . import api
        from .ops import dpk_fuse
        from .ops import fused_encode as fe
        from .ops.repair import _SLACK

        device = api.checked_device(device)
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
        # the JAX writer's dpk_seg (dctz_tpu/stream.py:227-238): DPK frames
        # on kernels A + B for the device ids on float32 data at their
        # geometry (blocks of 64, 255 bins) with truncate on, at any brsf
        # (an operand of A). Everything else writes host-coded frames; a
        # float64 array with the device ids among them, whose ids take
        # Huffman-only deflate (api._ids_streams)
        dpk_seg = (cfg.ids_codec == "device" and cfg.mode in ("ec", "qt")
                   and dtype == np.float32 and cfg.truncate
                   and dpk_fuse.default_geometry(cfg))
        tdtype = torch.float64 if dtype == np.float64 else torch.float32
        bs = cfg.block_size
        segment_elems = max(bs, segment_elems - segment_elems % bs)

        # pass 1: global statistics
        if isinstance(x, torch.Tensor):
            x = timing.to_device(x, device)
            amax_d, total_d, vmax_d, vmin_d = _stats_stream_device(x)
            amax = amax_d
            total, vmax, vmin = (timing.item(total_d), timing.item(vmax_d),
                                 timing.item(vmin_d))
        else:
            amax, total, vmax, vmin = _stats_stream_host(x, segment_elems)
            amax = timing.scalar(amax, tdtype, device)
        from .core.stats import scaling_factor

        sf_t = scaling_factor(amax, cfg.sf_adj)
        sf = timing.item(sf_t)
        # the header's mean is total / n in doubles, unrounded, as the JAX
        # writer stores it (dctz_tpu/stream.py:200); total is a float32 sum
        # on the device route and a float64 sum of segment sums on the host
        # route, so the two routes store different means, as the JAX
        # package's do
        mean = total / n
        # the verify tolerance is GLOBAL (eb times the range of the whole
        # array), computed in python doubles and rounded once to the
        # segment dtype, as the JAX stream writer does
        tol_t = timing.scalar((vmax - vmin) * cfg.error_bound * _SLACK, tdtype,
                              device)

    # QT: the global column max over every segment first, max-reduced (max
    # is associative: equal to the whole-array pass): kernel E on DPK
    # segments, _qtable_colmax_segment on generic ones; frames store it
    # clamped, with slot 0 patched to their own last block's DC
    qt_ext = None
    if cfg.mode == "qt":
        with t.span("pipeline.qtable", tile=True):
            for seg in _segments(x, segment_elems):
                if dpk_seg:
                    q1 = fe.qtable_qmax(_on_device(seg, device), sf_t,
                                        cfg.error_bound,
                                        relaxed=api._relaxed(cfg),
                                        brsf=cfg.brsf)
                else:
                    q1 = _qtable_colmax_segment(_on_device(seg, device, pad=False),
                                                int(seg.shape[0]), sf_t, cfg)
                qt_ext = q1 if qt_ext is None else torch.maximum(qt_ext, q1)

    def write_frame(blob: bytes) -> int:
        out.write(_FRAME.pack(len(blob)))
        out.write(blob)
        t.count("frames")
        return _FRAME.size + len(blob)

    with t.span("pipeline.write", tile=True):
        written = _HDR.size
        out.write(_HDR.pack(MAGIC, 1, 0, n))
    bound_bad: list[int] = []  # segments where repair fell short
    host_worker = concurrent.futures.ThreadPoolExecutor(1)

    def hand_off(pack, si):
        # the worker takes segment si's pull and pack
        return host_worker.submit(t.carry(_pack_frame), *pack, bound_bad, si)

    try:
        pending = None
        for si, seg in enumerate(_segments(x, segment_elems)):
            # each segment's device stage blocks on its overflow flag, so
            # this span covers the segment's device work
            with t.span("pipeline.encode", si, tile=True):
                n_seg = int(seg.shape[0])
                if dpk_seg:
                    xs = _on_device(seg, device)
                    outs, planes, qt_seg = _encode_segment_dpk(
                        xs, n_seg, sf_t, tol_t, cfg, qt_ext)
                    pull = _start_pull(_pull_list(outs, planes, qt_seg, cfg))
                    pack = (_pack_segment_dpk, pull, planes is not None, n_seg,
                            int(xs.shape[0]), sf, mean, cfg)
                else:
                    q, ok = _encode_segment(_on_device(seg, device, pad=False),
                                            n_seg, sf_t, tol_t, cfg, qt_ext)
                    pull = _start_pull([q.bin_ids, q.dc, q.ac_buf, q.ac_count,
                                        q.qtable, ok])
                    pack = (_pack_segment, pull, n_seg, sf, mean, cfg, dtype)
                if pending is None:
                    pending = hand_off(pack, si)
                    continue
            with t.span("pipeline.wait", si - 1, tile=True):
                blob = pending.result()
            with t.span("pipeline.write", si - 1, tile=True):
                written += write_frame(blob)
                pending = hand_off(pack, si)
        with t.span("pipeline.wait", si, tile=True):
            blob = pending.result()
        with t.span("pipeline.write", si, tile=True):
            written += write_frame(blob)
            out.write(_FRAME.pack(0))
            host_worker.shutdown()
            _warn_bound(bound_bad)
    finally:
        host_worker.shutdown()
    return written + _FRAME.size


def _pack_frame(pack, pull, *args):
    """The writer worker's task for one segment (its index last in args):
    wait for its copies (pack.pull: device completion plus transfer), then
    pack(host arrays, *args) (pack.host, host CPU only)."""
    with timing.span("pack.pull", args[-1]):
        host = pull()
    with timing.span("pack.host", args[-1], cpu=True):
        return pack(host, *args)


def _warn_bound(bound_bad: list) -> None:
    if bound_bad:
        import warnings

        timing.count("bound_shortfalls", len(bound_bad))

        warnings.warn(
            "verify-repair could not fully satisfy the pointwise bound in "
            f"segment(s) {bound_bad} (float32-truncation floor)",
            stacklevel=4,
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
    if timing.item(outs[7]):
        timing.count("retries")
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


def _pack_segment_dpk(host, plane_mode: bool, n: int, n_pad: int, sf: float,
                      mean: float, cfg: CodecConfig,
                      bound_bad: list | None = None, seg_index: int = 0,
                      dtype=np.float32, n_stream: int | None = None) -> bytes:
    """Host stage of one DPK segment (on the writer's worker thread, or on
    the caller's for a monolithic container): the same v2 container the
    monolithic path emits, from the segment's host arrays (_pull_list's,
    pulled): the sections (span zlib.sections), then the container (span
    zlib.container). dtype: the header's, float64 for a monolithic float64
    array cast by internal_dtype="float32"; n_stream: the id stream's length
    (api._dpk_v2_streams)."""
    from . import api

    with timing.span("zlib.sections", cpu=True, tile=True):
        (width, packed, exc_rows, exc_counts, counts, dc_s, ac_s, ok,
         qtable) = host
        if ok is not None and bound_bad is not None and not bool(ok):
            bound_bad.append(seg_index)
        header = api._header(cfg, n, int(counts.sum()), sf, mean, dtype)
        planes = dict(dc_planes=dc_s, ac_planes=ac_s) if plane_mode else {}
        streams = api._dpk_v2_streams(
            header, width, packed, exc_rows, exc_counts, counts,
            None if plane_mode else ac_s, None if plane_mode else dc_s, n_pad,
            cfg, n_stream=n_stream, **planes,
        )
    with timing.span("zlib.container", cpu=True, tile=True):
        return ct.pack_v2(header, streams, qtable, cfg.chunk_bytes)


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


def _pack_segment(host, n: int, sf: float, mean: float, cfg: CodecConfig,
                  dtype=np.float32, bound_bad: list | None = None,
                  seg_index: int = 0) -> bytes:
    """Host stage of one generic segment (dctz_tpu/stream.py:467-516, byte
    for byte): a host-coded v2 frame of `dtype` whatever cfg.container
    says. The id sections of the n real ids (api._ids_streams); DC and AC
    (float32, or 8-byte items at full width) always shuffled (cfg.shuffle)
    and chunk-deflated, never plane-coded; the DC delta (cfg.dc_delta) on
    the host for a float32 frame (a float64 frame keeps raw DC); the qtable
    stored in QT mode only. host: the segment's pulled (ids, dc, AC rows,
    counts, qtable, ok)."""
    from . import api
    from .core import entropy

    ids, dc, ac_rows, counts, qtable, ok = host
    if ok is not None and bound_bad is not None and not bool(ok):
        bound_bad.append(seg_index)
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
    return ct.pack_v2(header, streams, qtable if cfg.mode == "qt" else None,
                      cfg.chunk_bytes)


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
    """Validate the DTZS magic, version and reserved field (every writer
    stores 0 there); returns total_elements."""
    hdr = bytes(f.read(_HDR.size))
    if len(hdr) != _HDR.size:
        raise ValueError("truncated stream: missing stream header")
    magic, version, res, total = _HDR.unpack(hdr)
    if magic != MAGIC:
        raise ValueError("not a DCTZ-TPU stream")
    if version != 1:
        raise ValueError(f"unsupported stream version {version}")
    if res:
        raise ValueError(f"corrupted stream: reserved field {res:#06x} is not 0")
    return total


def alloc_output(total: int, dtype) -> np.ndarray:
    """The output of a whole-stream restore, total elements of dtype. The
    header's count is not checksummed: a count no host can allocate is a
    corrupted header, reported as one (ValueError, not MemoryError)."""
    try:
        return np.empty(total, dtype)
    except (MemoryError, ValueError) as e:
        raise ValueError(f"corrupted stream: its header claims {total} "
                         "elements") from e


def decompress_stream(f: BinaryIO, timer=None,
                      device: str | torch.device = "cuda") -> Iterator[np.ndarray]:
    """Yield the reconstructed segments in order (the bounded-memory restore
    path: peak incremental memory is about one segment beside the host
    stages of the frames prepped ahead). Worker threads run the host
    stages of the next frames (crc parse, side-stream inflation, and the
    host-coded frames' row re-padding; PREP_AHEAD of them on a CUDA
    device, one on the CPU device) while this thread runs frame k's
    device stage; on a CUDA device each frame's copy through pinned
    staging is done before its segment is yielded. timer: a utils.timing.StageTimer that takes the
    reader's spans (module docstring) and counters."""
    _read_stream_header(f)
    for n, dtype, run in _frame_stages(f, timing.resolve(timer),
                                       torch.device(device), overlap=False):
        yield run(np.empty(n, dtype))


class _StagedCopies:
    """The reader's copies of its decoded frames into the host output on a
    CUDA device (module docstring): a ring of two pinned staging buffers,
    each with its own side stream, and one worker that fills the output
    from them on FILL_THREADS threads. The buffers come from torch's caching host allocator, so a
    later call reuses them."""

    def __init__(self, t, device: torch.device) -> None:
        self._t = t
        self._streams = [torch.cuda.Stream(device) for _ in range(2)]
        self._bufs: list[torch.Tensor | None] = [None, None]
        self._pending: list[concurrent.futures.Future | None] = [None, None]
        self._next = 0
        self._worker = concurrent.futures.ThreadPoolExecutor(1)
        self._fillers = concurrent.futures.ThreadPoolExecutor(FILL_THREADS)

    def start(self, dst: np.ndarray, x: torch.Tensor, fi: int) -> None:
        """Enqueue the copy of x (a decoded frame, on the current stream)
        into dst: x to the next staging buffer on its side stream, once the
        copy of the frame two back has left that buffer, then the
        worker's fill of dst."""
        slot = self._next
        self._next ^= 1
        self._wait(slot)
        n = x.shape[0]
        buf = self._bufs[slot]
        if buf is None or buf.dtype != x.dtype or buf.shape[0] < n:
            buf = self._bufs[slot] = torch.empty(n, dtype=x.dtype,
                                                 pin_memory=True)
        side = self._streams[slot]
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            buf[:n].copy_(x, non_blocking=True)
        x.record_stream(side)
        self._t.count("bytes_d2h_pinned", x.nbytes)
        self._t.count("frames_staged")
        self._pending[slot] = self._worker.submit(
            self._t.carry(_fill), side, buf[:n].numpy(), dst, fi,
            self._fillers)

    def _wait(self, slot: int) -> None:
        fut, self._pending[slot] = self._pending[slot], None
        if fut is not None:
            fut.result()

    def drain(self) -> None:
        """Wait for every copy in flight (in the order they started)."""
        for slot in (self._next, self._next ^ 1):
            self._wait(slot)

    def close(self) -> None:
        """Cancel the fills not started and wait for the one running."""
        self._worker.shutdown(cancel_futures=True)
        self._fillers.shutdown()


def _fill(side, staged: np.ndarray, dst: np.ndarray, fi: int,
          fillers: concurrent.futures.Executor) -> None:
    """The copy worker's task for frame fi: wait for its staging copy on
    the side stream, then copy it into dst in FILL_THREADS slices at once
    (numpy's copy releases the GIL)."""
    with timing.span("copy_out.host", fi):
        timing.wait(side)
        step = max(1, -(-staged.shape[0] // FILL_THREADS))
        list(fillers.map(lambda a: np.copyto(dst[a : a + step],
                                             staged[a : a + step]),
                         range(0, staged.shape[0], step)))


def _frame_stages(f, t, device: torch.device, overlap: bool = True,
                  ahead: int | None = None):
    """Yield (n, dtype, run) per frame in order: its element count and
    dtype, and the function that runs its device stage on the caller's
    thread and writes the frame's n samples into a given array (which it
    returns). The host stages of frames k + 1 to k + ahead are already
    running on workers when frame k is yielded (ahead: PREP_AHEAD on a
    CUDA device, 1 on the CPU device, whose decode itself takes the
    host's cores); a frame that cannot be read raises where a reader one
    frame ahead would, in the wait for the frame before it. t: the tracer
    (utils.timing.resolve); the caller's spans close before each yield. On
    a CUDA device run copies the frame out through _StagedCopies: with
    overlap the copy may still be running when run returns (every copy is
    done when this generator ends), without it run returns with the copy
    done. On the CPU device run copies the frame straight into the
    array."""
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
        with timing.span("prep", fi):
            header, qtable, host_arrays, decode = api._host_stage(blob)
        n = header.num_elements

        def run(dst: np.ndarray) -> np.ndarray:
            with t.span("pipeline.decode", fi, tile=True):
                dev, sf, qt = api._to_device(host_arrays, header, qtable, device)
                x = decode(dev, sf, qt)
            with t.span("copy_out", fi, tile=True):
                if copies is None:
                    # straight into the output
                    timing.copy_to_host(torch.from_numpy(dst), x[:n])
                else:
                    copies.start(dst, x[:n], fi)
                    if not overlap:
                        copies.drain()
                t.count("frames")
            return dst

        return n, header.dtype, run

    cuda = device.type == "cuda"
    if ahead is None:
        ahead = PREP_AHEAD if cuda else 1
    copies = _StagedCopies(t, device) if cuda else None
    preps = concurrent.futures.ThreadPoolExecutor(ahead)
    queued = collections.deque()  # the preps of the frames read, in order
    late = None  # (index, error) of the frame whose read failed
    try:
        fi, nread, eof = 0, 0, False
        while True:
            # reading the next frames and handing them to the workers count
            # as the wait for frame k's host stage
            with t.span("pipeline.wait", fi, tile=True):
                while not (eof or late) and nread <= fi + ahead:
                    try:
                        blob = read_frame()
                    except ValueError as e:
                        late = (nread, e)
                        break
                    if blob is None:
                        eof = True
                    else:
                        queued.append(preps.submit(t.carry(prep), blob, nread))
                        nread += 1
                # a frame that cannot be read fails the wait for the frame
                # before it, however far ahead it was read
                if late is not None and late[0] <= fi + 1:
                    raise late[1]
                if not queued:
                    return
                stage = queued.popleft().result()
                if eof and not queued:
                    preps.shutdown()
            yield stage
            fi += 1
            if eof and not queued:
                break
        if copies is not None:
            with t.span("copy_out", tile=True):
                copies.drain()
                copies.close()
    finally:
        preps.shutdown(cancel_futures=True)
        if copies is not None:
            copies.close()


def decompress_stream_all(f: BinaryIO, timer=None,
                          device: str | torch.device = "cuda") -> np.ndarray:
    """Reassemble the whole array from a stream into one output buffer,
    allocated once from the stream header's element count and the first
    frame's dtype (dctz_tpu/stream.py:653); each frame's device stage writes
    its samples into it, on a CUDA device through pinned staging while the
    next frames decode (peak incremental memory beyond the output is the
    host stages of the frames prepped ahead and, on a CUDA device, two
    pinned frames). timer: as decompress_stream's."""
    with timing.using(timer) as t:
        total = _read_stream_header(f)
        out = None
        off = 0
        for n, dtype, run in _frame_stages(f, t, torch.device(device)):
            if out is None:
                out = alloc_output(total, dtype)
            if off + n > total:
                raise ValueError(f"stream frames hold more than its {total} "
                                 f"elements")
            run(out[off : off + n])
            off += n
    if out is None or off != total:
        raise ValueError(f"truncated stream: {off} of {total} elements restored")
    return out
