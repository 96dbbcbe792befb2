"""Tracing of the port: stages, spans and counters (port of
dctz_tpu/utils/timing.py).

How an operator turns tracing on: pass a StageTimer to compress() or
decompress() (or to the stream writer and readers, `timer=`), and, for a
Chrome trace of the host ranges beside the card's kernels and copies, run
the calls under device_trace(log_dir). Nothing else turns it on: no
environment variable, no CodecConfig field.

    t = StageTimer()
    with device_trace("build/trace"):       # optional; None: no trace
        blob = dz.compress(x, config=cfg, timer=t)
    t.print_report(x.nbytes)                # stages, spans, counters
    t.spans                                 # every span, in open order

A stage (`t.stage(name)`) is one of the API's: "transfer" (host-device
copies), "device" (kernels), "zlib" (compress: section coding and container
assembly), "rate" (rate="auto": the trial encodes that pick brsf), "host"
(decompress: parse, inflate and, but for DPK, re-pad) and "pipeline" (a
segmented DTZS stream). With sync=True every stage boundary calls
torch.cuda.synchronize(), so that a stage ending in device work is timed
to its end. A span
(`t.span(name, index)`, or `span(name)` here for code that is handed no
timer) marks the work inside them and never synchronizes. Both add their
wall seconds to `t.stages[name]` (spans of one name sum) and one record
Span(name, index, t0, t1, thread, parent) to `t.spans`; `parent` is the
position in `t.spans` of the span open on that thread, or, for work handed
to a pool (carry), of the span that handed it over. Spans of the host
entropy layer (`cpu=True`) also add their thread's CPU seconds to
`t.stages["cpu.entropy"]`, as do the pool tasks they start, each thread's
seconds counted once. `t.counts` holds the counters kept at the same
boundaries: "syncs" (host-blocking waits on the device: item(), to_host(),
copy_to_host(), a blocking to_device() or scalar(), wait()), bytes moved
("bytes_h2d_pageable", "bytes_h2d_pinned", "bytes_d2h_pageable",
"bytes_d2h_pinned"), "frames" (DTZS frames written or restored),
"frames_staged" (restored frames copied out through pinned staging, on a
CUDA device), "rows_laid_on_device" (DPK containers whose fixed-capacity
rows kernel N or its twin laid out from the tight streams:
ops/dpk_fuse.dpk_rows_layout), "retries"
(full-width re-encodes after an overflow) and "bound_shortfalls" (arrays or
frames whose verify-repair fell short of the bound). On the CPU device the
reads count as syncs too (the same boundaries, nothing to wait for) and no
bytes move.

The spans' names, by the thread they run on:

  DTZS writer   caller: pipeline.stats, pipeline.qtable, pipeline.encode,
                pipeline.wait, pipeline.write (they tile "pipeline");
                worker: pack.pull, pack.host
  DTZS reader   caller: pipeline.wait, pipeline.decode, copy_out (they tile
                "pipeline"); workers: prep, copy_out.host (CUDA device)
  entropy       caller or worker: zlib.sections, zlib.container (they tile
                "zlib"), host.parse, host.prep (they tile "host");
                section pool: section.dc, section.ac, section.ids
  any thread    sync, around each wait counted in "syncs"

Where a profiler records the thread, every stage and span also opens a
range "stage.<name>": on the thread that started torch.profiler.profile
(which records that thread alone), and on every thread under
device_trace. The ranges of one thread follow one another, each opening
just before the one it follows closes, so that at any instant the range
opened last is open (a trace's idle gaps take its name): an inner span
closes its parent's range and opens it again when it ends, except the
spans that tile their enclosing one (`tile=True`: the caller's spans listed
above as tiling a stage, and zlib.*, host.* on a worker), whose range stays
open until the next tile opens or the enclosing span ends, so that the
instants between two tiles (the tracing's own bookkeeping, a
synchronizing stage's closing wait) carry an inner name too.

Off (no timer passed and no profiler recording) every stage and span is one
shared no-op context: no timer object, no clock read, no range.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, NamedTuple

import torch

#: the stage key that sums the host entropy layer's thread CPU seconds
CPU_KEY = "cpu.entropy"


class Span(NamedTuple):
    name: str
    index: int | None
    t0: float
    t1: float
    thread: str
    parent: int | None  # position in StageTimer.spans


class _Context(threading.local):
    """What a thread is tracing into: the tracer (None: off), the position
    of its innermost open span, whether an open span counts its CPU
    seconds, the names of its open spans (innermost last), and its open
    profiler range (name, record_function)."""

    tracer = None
    parent = None
    cpu = False
    open = None

    def __init__(self) -> None:
        self.names = []


_ctx = _Context()


#: device_trace()s recording now; they record every thread
_all_threads = 0


def _profiling() -> bool:
    """A profiler records this thread's ranges: torch's thread-local flag
    (the thread that started a profiler recording one thread, as
    torch.profiler.profile does by default; it reads False on the others),
    or a device_trace, which records every thread (under which that flag
    reads False everywhere)."""
    return _all_threads > 0 or torch._C._autograd._profiler_enabled()


def _open_range(ctx: _Context, name: str) -> None:
    """Open the range of `name` on this thread, then close the one open
    there, so that no instant of the thread lies outside the range opened
    last."""
    prev = ctx.open
    rf = torch.profiler.record_function("stage." + name)
    rf.__enter__()
    ctx.open = (name, rf)
    if prev is not None:
        prev[1].__exit__(None, None, None)


def _end_range(ctx: _Context, tile: bool) -> None:
    """A span has ended (its name popped from ctx.names): its range closes
    and the enclosing span's opens again; a tile's range stays open until
    the thread's next range opens or its enclosing span ends."""
    if ctx.open is None or (tile and ctx.names):
        return
    if ctx.names and _profiling():
        mine = ctx.open[1]
        _open_range(ctx, ctx.names[-1])
        mine.__exit__(None, None, None)
    else:
        mine, ctx.open = ctx.open[1], None
        mine.__exit__(None, None, None)


class _Null:
    """The shared no-op context of every stage and span when off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NULL = _Null()


class _Off:
    """No timer and no profiler."""

    __slots__ = ()

    def stage(self, name: str) -> _Null:
        return _NULL

    def span(self, name: str, index: int | None = None, cpu: bool = False,
             tile: bool = False) -> _Null:
        return _NULL

    def count(self, key: str, n: int = 1) -> None:
        return None

    def carry(self, fn):
        return fn


OFF = _Off()


class _Span:
    """One stage or span of `tracer` (a StageTimer, or RANGES: ranges
    only)."""

    __slots__ = ("tracer", "name", "index", "cpu", "sync", "tile", "_saved",
                 "_id", "_parent", "_t0", "_c0")

    def __init__(self, tracer, name: str, index, cpu: bool, sync: bool,
                 tile: bool = False):
        self.tracer, self.name, self.index = tracer, name, index
        self.cpu, self.sync, self.tile = cpu, sync, tile

    def __enter__(self) -> None:
        # the clock is read first here and last in __exit__, so that spans
        # that follow one another leave next to nothing between them
        t0 = time.perf_counter()
        ctx = _ctx
        tr = self.tracer
        self._saved = (ctx.tracer, ctx.parent, ctx.cpu)
        ctx.names.append(self.name)
        if _profiling():
            _open_range(ctx, self.name)
        if tr is not RANGES:
            self._parent = ctx.parent if ctx.tracer is tr else None
            with tr._lock:
                self._id = len(tr.spans)
                tr.spans.append(None)  # filled when the span ends
            ctx.parent = self._id
            self._c0 = None
            if self.cpu and not ctx.cpu:
                ctx.cpu = True
                self._c0 = time.thread_time()
            if self.sync:  # a stage starts once the device is idle
                tr._sync()
                t0 = time.perf_counter()
            self._t0 = t0
        ctx.tracer = tr
        return None

    def __exit__(self, *exc) -> None:
        ctx = _ctx
        tr = self.tracer
        timed = tr is not RANGES
        if timed:
            if self.sync:
                tr._sync()
            cpu_s = None if self._c0 is None else time.thread_time() - self._c0
        ctx.names.pop()
        _end_range(ctx, self.tile)
        ctx.tracer, ctx.parent, ctx.cpu = self._saved
        if timed:
            t1 = time.perf_counter()
            rec = Span(self.name, self.index, self._t0, t1,
                       threading.current_thread().name, self._parent)
            with tr._lock:
                tr.spans[self._id] = rec
                tr.stages[self.name] = tr.stages.get(self.name, 0.0) + (
                    t1 - self._t0)
                if cpu_s is not None:
                    tr.stages[CPU_KEY] = tr.stages.get(CPU_KEY, 0.0) + cpu_s
        return None


def _carried(tracer, fn):
    """fn, to run on a pool thread in this thread's context: tracer, the
    open span as the parent, and the CPU seconds counted where an open span
    here counts its own."""
    ctx = _ctx
    mine = ctx.tracer is tracer
    parent = ctx.parent if mine else None
    cpu = ctx.cpu and mine and tracer is not RANGES

    def run(*args, **kwargs):
        c = _ctx
        saved = (c.tracer, c.parent, c.cpu)
        c.tracer, c.parent = tracer, parent
        c0 = None
        if cpu and not c.cpu:
            c.cpu = True
            c0 = time.thread_time()
        try:
            return fn(*args, **kwargs)
        finally:
            if c0 is not None:
                tracer._add(CPU_KEY, time.thread_time() - c0)
            c.tracer, c.parent, c.cpu = saved

    return run


class _Ranges:
    """A profiler records, and no timer was passed: ranges only."""

    __slots__ = ()

    def stage(self, name: str) -> _Span:
        return _Span(self, name, None, False, False)

    def span(self, name: str, index: int | None = None, cpu: bool = False,
             tile: bool = False) -> _Span:
        return _Span(self, name, index, False, False, tile)

    def count(self, key: str, n: int = 1) -> None:
        return None

    def carry(self, fn):
        return _carried(self, fn)


RANGES = _Ranges()


class StageTimer:
    """Accumulates stage and span seconds, span records and counters
    (module docstring); safe to update from pool threads."""

    def __init__(self, sync: bool = False) -> None:
        self.stages: dict[str, float] = {}
        self.spans: list[Span] = []
        self.counts: dict[str, int] = {}
        #: rate="auto": (brsf, container bytes, seconds) of each trial
        #: encode, in ladder order (api._auto_rate_brsf)
        self.rate_trials: list[tuple[float, int, float]] = []
        self.sync = sync
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def _sync(self) -> None:
        if self.sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def _add(self, key: str, seconds: float) -> None:
        with self._lock:
            self.stages[key] = self.stages.get(key, 0.0) + seconds

    def __enter__(self) -> "StageTimer":
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._sync()
        self.total = time.perf_counter() - self._t0

    def stage(self, name: str) -> _Span:
        """An API stage: synchronizes at both ends when self.sync."""
        return _Span(self, name, None, False, self.sync)

    def span(self, name: str, index: int | None = None, cpu: bool = False,
             tile: bool = False) -> _Span:
        """A span inside a stage; cpu=True also sums its thread CPU seconds
        into stages["cpu.entropy"]; tile=True marks one of the spans that
        tile their enclosing one (its range stays open until the next)."""
        return _Span(self, name, index, cpu, False, tile)

    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counts[key] = self.counts.get(key, 0) + n

    def carry(self, fn):
        """fn, to run on a pool thread in the submitting thread's context."""
        return _carried(self, fn)

    def report(self, nbytes: int | None = None) -> dict:
        """Structured breakdown: total and per-stage seconds, the counters,
        and MB/s."""
        total = getattr(self, "total", sum(self.stages.values()))
        out: dict = {"total_s": total, "stages_s": dict(self.stages),
                     "counts": dict(self.counts)}
        if nbytes is not None and total > 0:
            out["mb_per_s"] = nbytes / 1e6 / total
        return out

    def print_report(self, nbytes: int | None = None, label: str = "") -> None:
        r = self.report(nbytes)
        parts = ", ".join(f"{k}={v:.6f}(s)" for k, v in r["stages_s"].items())
        print(f"{label}{parts}")
        if r["counts"]:
            print(label + ", ".join(f"{k}={v}" for k, v in r["counts"].items()))
        if "mb_per_s" in r:
            print(
                f"{label}time = {r['total_s']:.6f} (s), rate = "
                f"{r['mb_per_s']:.3f} (MB/s)"
            )


def resolve(timer=None):
    """The tracer of a call: its timer, else RANGES while a profiler
    records this thread, else OFF."""
    if timer is not None:
        return timer
    return RANGES if _profiling() else OFF


class using:
    """`with using(timer) as t:` traces the body into resolve(timer) on
    this thread, and hides the tracer of any enclosing call (a call made
    with no timer records nothing into its caller's)."""

    __slots__ = ("tracer", "_saved")

    def __init__(self, timer=None) -> None:
        self.tracer = resolve(timer)

    def __enter__(self):
        ctx = _ctx
        self._saved = (ctx.tracer, ctx.parent)
        t = self.tracer
        if t is OFF:
            ctx.tracer, ctx.parent = None, None
        elif ctx.tracer is not t:
            ctx.tracer, ctx.parent = t, None
        return t

    def __exit__(self, *exc) -> None:
        _ctx.tracer, _ctx.parent = self._saved
        return None


def span(name: str, index: int | None = None, cpu: bool = False,
         tile: bool = False):
    """A span of this thread's tracer (the no-op context when off)."""
    t = _ctx.tracer
    return _NULL if t is None else t.span(name, index, cpu, tile)


def count(key: str, n: int = 1) -> None:
    t = _ctx.tracer
    if t is not None:
        t.count(key, n)


def carry(fn):
    """fn, to run on a pool thread in this thread's tracing context (fn
    itself when off)."""
    t = _ctx.tracer
    return fn if t is None else t.carry(fn)


def task(name: str, fn):
    """fn inside a span `name` of the host entropy layer (cpu=True), for a
    pool task (fn itself when off)."""
    if _ctx.tracer is None:
        return fn

    def run(*args, **kwargs):
        with span(name, cpu=True):
            return fn(*args, **kwargs)

    return run


# ---------------------------------------------------------------------------
# the host-device boundaries: each counts and opens a "sync" span where the
# host waits on the device
# ---------------------------------------------------------------------------


def _waited(t, kind: str | None = None, nbytes: int = 0) -> None:
    t.count("syncs")
    if kind is not None:
        t.count(kind, nbytes)


def item(x: torch.Tensor):
    """x.item() (what bool() and float() of a tensor do): the host reads a
    device value."""
    t = _ctx.tracer
    if t is None:
        return x.item()
    with t.span("sync"):
        v = x.item()
    _waited(t, "bytes_d2h_pageable" if x.device.type != "cpu" else None,
            x.element_size())
    return v


def to_host(x: torch.Tensor) -> torch.Tensor:
    """x.cpu(): a blocking copy into pageable host memory."""
    t = _ctx.tracer
    if t is None:
        return x.cpu()
    with t.span("sync"):
        h = x.cpu()
    _waited(t, "bytes_d2h_pageable" if x.device.type != "cpu" else None,
            x.nbytes)
    return h


def copy_to_host(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst.copy_(src), dst a host tensor over pageable memory: blocks until
    src's producers and the copy are done."""
    t = _ctx.tracer
    if t is None:
        dst.copy_(src)
        return
    with t.span("sync"):
        dst.copy_(src)
    _waited(t, "bytes_d2h_pageable" if src.device.type != "cpu" else None,
            src.nbytes)


def to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """x on `device`: a blocking copy (a wait) when x lies in host memory
    and device is not the CPU, x itself when it is already there."""
    if x.device.type != "cpu" or device.type == "cpu":
        return x.to(device)
    t = _ctx.tracer
    if t is None:
        return x.to(device)
    with t.span("sync"):
        out = x.to(device)
    _waited(t, "bytes_h2d_pinned" if x.is_pinned() else "bytes_h2d_pageable",
            x.nbytes)
    return out


def scalar(v, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """torch.tensor(v) on `device`: off the CPU, a blocking copy of one
    item."""
    t = _ctx.tracer
    if t is None or device.type == "cpu":
        return torch.tensor(v, dtype=dtype, device=device)
    with t.span("sync"):
        out = torch.tensor(v, dtype=dtype, device=device)
    _waited(t, "bytes_h2d_pageable", out.element_size())
    return out


def wait(stream) -> None:
    """Block until the work queued on a CUDA stream is done."""
    t = _ctx.tracer
    if t is None:
        stream.synchronize()
        return
    with t.span("sync"):
        stream.synchronize()
    _waited(t)


@contextlib.contextmanager
def device_trace(log_dir: str | None) -> Iterator[None]:
    """A torch.profiler trace of the body (CPU ranges of every thread, and
    the card's kernels, copies and memsets where there is one), written as a
    Chrome trace into log_dir when it ends; a no-op for None."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):  # a torch that records one thread only
        pass
    global _all_threads
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
            **kw):
        _all_threads += 1
        try:
            yield
        finally:
            _all_threads -= 1
