"""Segmented compression into the DTZS stream container (port of
dctz_tpu/stream.py, the DPK segment path).

A stream is a sequence of independent v2 containers behind a small frame
header:

    b"DTZS" | u16 version | u16 reserved | u64 total_elements
    repeat: u64 frame_len | v2 container bytes
    u64 0  (end marker)

A first pass computes the GLOBAL statistics (the scaling factor must see the
whole array; the verify tolerance is eb times the whole array's range), and
in QT mode the GLOBAL quantizer table (kernel E over every segment,
max-reduced). Each segment is then encoded with those fixed values by the
same kernels as the monolithic path (A + B, ops/dpk_fuse.encode_x_fused) and
packed by the same host code (api._pack_dpk_v2). Segments are block
multiples, so DCT blocks never cross a frame, and a stream decodes
bit-identically to the monolithic container of the same data whenever the
segment size is a multiple of the 1024-element pad quantum (the default
DEFAULT_SEGMENT is).

Both directions run a two-stage pipeline: the writer's host worker pulls and
packs segment k (its device-to-host copies run on a side CUDA stream) while
the device encodes segment k + 1; the reader's host worker re-inflates frame
k + 1 while the device decodes frame k. Besides the input, the device holds
at most two segments in flight.

Only DPK v2 frames (ids_codec="device", or "auto", which means it for v2)
are ported. Host-coded DTZS frames, the generic segment path of the JAX
package (stream._encode_segment, _qtable_colmax_segment, _pack_segment:
v1 configurations and the ids codecs "deflate" and "rans"), raise
NotImplementedError naming ROADMAP item 8 on both sides; the same
containers are ported monolithic (api.py).
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
    the sum is a float32 sum, as the JAX package's device branch takes it
    (dctz_tpu/stream.py:_stats_stream_device), equal to it up to the order
    of the float32 additions."""
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


def _on_device(seg, device: torch.device) -> torch.Tensor:
    """A segment as a float32 tensor on `device`, zero-padded to the tile
    quantum."""
    if isinstance(seg, np.ndarray):
        if not seg.flags.writeable:
            seg = seg.copy()
        seg = torch.from_numpy(seg)
    seg = seg.to(device)
    pad = (-seg.shape[0]) % _PAD_QUANTUM
    return torch.nn.functional.pad(seg, (0, pad)) if pad else seg


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
    """Compress the flat float32 array `x` into `out` as a DTZS stream of DPK
    v2 frames of segment_elems elements (rounded down to a block multiple);
    returns the bytes written.

    x: a numpy array (statistics on the host, one segment at a time; each
    segment then goes to `device`) or a tensor (moved to `device` once;
    statistics reduce there and the segments are slices of it).
    trace: an optional list collecting per-segment wall times
    ("device" | "pull" | "pack", segment, t0, t1)."""
    from . import api
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
    if dtype == np.float64:
        raise api._todo("float64 input", "9")
    if dtype != np.float32:
        raise TypeError(f"unsupported dtype {dtype}; use float32")
    n = int(x.shape[0])
    if n == 0:
        raise ValueError("cannot compress an empty array")
    cfg = api._resolve_ids_codec(cfg)
    api._check_slice(cfg)
    if cfg.container != "v2" or cfg.ids_codec != "device":
        raise api._todo(f"host-coded DTZS frames (container {cfg.container!r}, "
                        f"ids_codec {cfg.ids_codec!r})", "8")
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
        amax = torch.tensor(amax, dtype=torch.float32, device=device)
    from .core.stats import scaling_factor

    sf_t = scaling_factor(amax, cfg.sf_adj)
    sf = float(sf_t)
    # the header's mean is total / n in doubles, unrounded, as the JAX
    # writer stores it (dctz_tpu/stream.py:200); total is a float32 sum on
    # the device route and a float64 sum of segment sums on the host route,
    # so the two routes store different means, as the JAX package's do
    mean = total / n
    # the verify tolerance is GLOBAL (eb times the range of the whole
    # array), computed in python doubles and rounded once to float32, as
    # the JAX stream writer does
    tol_t = torch.tensor(np.float32((vmax - vmin) * cfg.error_bound * _SLACK),
                         device=device)

    # QT: the global qtable, kernel E over every segment first, max-reduced
    # (max is associative: equal to the whole-array pass); frames store it
    # with slot 0 patched to their own last block's DC
    qt_ext = None
    if cfg.mode == "qt":
        for seg in _segments(x, segment_elems):
            q1 = fe.qtable_qmax(_on_device(seg, device), sf_t, cfg.error_bound,
                                relaxed=api._relaxed(cfg))
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
            # blocks on the overflow flag, so this interval covers the
            # segment's device work
            xs = _on_device(seg, device)
            outs, planes, qt_seg = _encode_segment_dpk(
                xs, int(seg.shape[0]), sf_t, tol_t, cfg, qt_ext
            )
            if trace is not None:
                trace.append(("device", si, t0, time.perf_counter()))
            pull = _start_pull(_pull_list(outs, planes, qt_seg, cfg))
            if pending is not None:
                written += write_frame(pending.result())
            pending = host_worker.submit(
                _pack_segment_dpk, pull, planes is not None, int(seg.shape[0]),
                int(xs.shape[0]), sf, mean, cfg, bound_bad, si, trace,
            )
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
                        tol_t: torch.Tensor, cfg: CodecConfig, qt_ext):
    """Device stage of one DPK array: kernels A + B with the given sf,
    tolerance and qtable, retried once at full chunk width on exception
    overflow (the qtable does not depend on the width, so E is not rerun);
    cfg.dct_precision "high" takes A's RELAXED instantiation.
    xs: the array on its device, zero-padded to the 1024 tile quantum
    (_on_device), n of its samples real. The float32 DC/AC streams are
    split into byte planes on the device (api._plane_split2) so the host
    packer skips its shuffle. qt_seg: the qtable with slot 0 set to the last
    REAL block's DC. Returns (outs, planes, qt_seg). The monolithic
    container is the one-segment case (api._compress_fused)."""
    from . import api
    from .ops import dpk_fuse, idpack
    from .ops.fused_encode import patch_slot0

    cw = qz.chunk_width(int(xs.shape[0]), cfg.block_size)

    def encode(cape):
        return dpk_fuse.encode_x_fused(xs, sf_t, tol_t, n, cfg.error_bound,
                                       min(cape, cw), cw, cfg.verify, qt_ext,
                                       relaxed=api._relaxed(cfg))

    outs = encode(idpack.CAPE)
    if bool(outs[7]):
        outs = encode(cw)
    qt_seg = patch_slot0(qt_ext, outs[6], n) if qt_ext is not None else None
    planes = (api._plane_split2(outs[6], outs[4])
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
                      trace=None) -> bytes:
    """Host stage of one DPK segment (on the writer's worker thread, or on
    the caller's for a monolithic container): wait for the segment's copies (the "pull" interval: device completion plus
    transfer) and pack the same v2 container the monolithic path emits (the
    "pack" interval, host CPU only)."""
    from . import api

    tp0 = time.perf_counter()
    (width, packed, exc_rows, exc_counts, counts, dc_s, ac_s, ok,
     qtable) = pull()
    if ok is not None and bound_bad is not None and not bool(ok):
        bound_bad.append(seg_index)
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
    for n, run in _frame_stages(f, trace, torch.device(device)):
        yield run(np.empty(n, np.float32))


def _frame_stages(f, trace, device: torch.device):
    """Yield (n, run) per frame in order: its element count, and the
    function that runs its device stage on the caller's thread and writes
    the frame's n samples into a given float32 array (which it returns).
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
        """Host stage of one frame. A frame that is not a DPK v2 float32
        container raises (host-coded frames: ROADMAP item 8)."""
        t0 = time.perf_counter()
        header, streams, qtable = api._parse_dpk(blob)
        host_arrays, (n_stream, tile_b, cw, cfg) = api._dpk_decode_prep(
            header, streams
        )
        n = header.num_elements
        if trace is not None:
            trace.append(("prep", fi, t0, time.perf_counter()))

        def run(dst: np.ndarray) -> np.ndarray:
            t1 = time.perf_counter()
            dev, sf, qt = api._to_device(host_arrays, header, qtable, device)
            x = api._decode_device_dpk(*dev, n_stream, cfg, tile_b, cw, sf,
                                       header.dcd, qt)
            torch.from_numpy(dst).copy_(x[:n])  # straight into the output
            if trace is not None:
                trace.append(("device", fi, t1, time.perf_counter()))
            return dst

        return n, run

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
    allocated once from the stream header's element count; each frame's
    device stage writes its samples straight into it (peak incremental
    memory beyond the output is about one segment)."""
    total = _read_stream_header(f)
    out = np.empty(total, np.float32)
    off = 0
    for n, run in _frame_stages(f, trace, torch.device(device)):
        if off + n > total:
            raise ValueError(f"stream frames hold more than its {total} "
                             f"elements")
        run(out[off : off + n])
        off += n
    if off != total:
        raise ValueError(f"truncated stream: {off} of {total} elements restored")
    return out
