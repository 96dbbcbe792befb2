"""The port's benchmark: the measurement of bench.py (the JAX package's,
at the repo root) for the PyTorch port on one NVIDIA GPU.

    python -m dctz_tpu_torch.bench [--out PATH] [--device cuda|cpu] [--n N]

Defaults: the card, N = 32Mi elements (128 MB of float32), the full record
written to build/bench_torch.json. Without a card the run exits 2 unless
--device cpu is given: the CPU rehearsal, whose record says "platform":
"cpu" and leaves every card metric (sync latency, peak device memory, the
card's name) null. It imports torch, numpy and this package, never jax.

The workload is bench.py's: a climate-shaped float32 array made on the
device (utils/bench_data.climate_formula_torch), EC at the 1E-3 bound, a v2
container with device-packed ids (DPK), verify on. CFG_DEFAULT leaves
segment_elems at "auto", which writes two 16Mi DTZS frames at 32Mi; CFG is
the monolithic container (segment_elems=0). Each section is printed as one
JSON line {"section": ...}:

  headline   compress(x, config=CFG_DEFAULT) then decompress(blob) through
             the public API, REPS times each, on the host clock with a
             synchronize around each call. Host-device copies are real costs
             on a PCIe card, so they stay inside: GB/s = 2 * bytes /
             (median compress + median decompress). The bound is checked on
             the array that was compressed, pulled to the host once; its
             distance from climate_formula_np is reported beside it.
  monolithic the same for CFG, with StageTimer(sync=True) stages
  amortized  the device stage alone: AMORT_K back-to-back calls between
             CUDA events with one synchronize, of the code compress() and
             decompress() dispatch (api._stats_device,
             fused_encode.tolerance, stream._encode_segment_dpk: kernels A
             and B; api._decode_dpk_upload on api._dpk_decode_prep's
             arrays, moved to the card once: kernels N, C and D), with the
             synchronizing calls found inside one call (each is inside the
             timed window: the API makes it too)
  sync_us    median of 8 synchronized trivial launches
  overlap    bench.py's measured overlap fraction of the two-stage DTZS
             pipeline, from the stream's spans (StageTimer.spans) of a
             4-segment compress and restore (the second of two runs)
  pipelined_model  bench.py's model of the default path's steady state
             from the amortized device stages, the monolithic host stages
             and the measured overlap: a model, not the headline
  big        compress_stream of a device-resident BIG_FACTOR * N array (1
             GB at the default N) in DEFAULT_SEGMENT frames: the measured
             wall GB/s (pulls included: real copies here) and bench.py's
             modelled steady state
  peak memory  torch.cuda.max_memory_allocated() of one headline compress,
             one decompress and the big point, each after
             reset_peak_memory_stats()
  native     the C++ reference codec (cpp/, dctz_tpu_torch.native) on the
             host, on climate_formula_np(N); vs_baseline = headline GB/s /
             its GB/s. A library that does not build fails the run.

The last stdout line is a compact JSON of at most 1,000 bytes: the metric,
value, unit, vs_baseline, compress and decompress GB/s, ratio,
bound_satisfied, host_codec, platform and the card's name and power limit
(nvidia-smi). tools/sync_bench.py writes README.md's block from a committed
record of the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from . import api, native, stream
from .api import compress, decompress
from .config import CodecConfig
from .core import container as ct
from .core import entropy
from .parallel.multihost import _scan_frames
from .utils.bench_data import climate_formula_np, climate_formula_torch
from .utils.metrics import evaluate
from .utils.timing import StageTimer

N = 1 << 25  # 32Mi elements, 128 MB float32
EB = 1e-3
CFG = CodecConfig(
    mode="ec", error_bound=EB, container="v2", ids_codec="device",
    verify=True, segment_elems=0,
)
CFG_DEFAULT = CodecConfig(
    mode="ec", error_bound=EB, container="v2", ids_codec="device",
    verify=True,  # segment_elems="auto": two 16Mi DTZS frames at N
)
REPS = 7
AMORT_K = 64
AMORT_REPS = 3
SYNC_SAMPLES = 8
OVERLAP_SEGMENTS = 4
BIG_FACTOR = 8  # the big point: 2**28 elements (1 GB) at the default N
BIG_FRAMES = 16
NATIVE_REPS = 2
LAST_LINE_MAX = 1000
DEFAULT_OUT = "build/bench_torch.json"
METRIC = ("compress+decompress GB/s, public API, climate f32, EC 1E-3, "
          "verify on, segment_elems auto (DTZS from 32Mi), host-device "
          "copies included, medians of warm runs")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev: torch.device):
    """(fn(), seconds) on the host clock, synchronized before and after."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _spread(times: list[float]) -> dict:
    return {"min_s": min(times), "median_s": statistics.median(times),
            "max_s": max(times), "runs_s": times}


def _peak_bytes(fn, dev: torch.device):
    """(fn(), {peak, resident before, peak above it} in bytes), or None for
    the memory on the CPU."""
    if dev.type != "cuda":
        return fn(), None
    _sync(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    return out, {"peak_bytes": peak, "resident_before_bytes": before,
                 "peak_above_resident_bytes": peak - before}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def measure_headline(x: torch.Tensor, dev: torch.device) -> dict:
    """The default path through the public API (module docstring)."""
    blob = compress(x, config=CFG_DEFAULT, device=dev)  # warm
    decompress(blob, device=dev)
    blob, peak_c = _peak_bytes(lambda: compress(x, config=CFG_DEFAULT, device=dev), dev)
    y, peak_d = _peak_bytes(lambda: decompress(blob, device=dev), dev)
    t_c, t_d = [], []
    for _ in range(REPS):
        blob, s = _timed(lambda: compress(x, config=CFG_DEFAULT, device=dev), dev)
        t_c.append(s)
        y, s = _timed(lambda: decompress(blob, device=dev), dev)
        t_d.append(s)
    gb = x.numel() * x.element_size() / 1e9
    c, d = statistics.median(t_c), statistics.median(t_d)
    return {"blob": blob, "y": y, "gbps": 2 * gb / (c + d),
            "compress_gbps": gb / c, "decompress_gbps": gb / d,
            "compress": _spread(t_c), "decompress": _spread(t_d),
            "frames": (len(_scan_frames(memoryview(blob))[1])
                       if blob[:4] == stream.MAGIC else 0),
            "peak_memory": {"compress": peak_c, "decompress": peak_d}}


def measure_monolithic(x: torch.Tensor, dev: torch.device) -> dict:
    """The monolithic container (CFG) through the public API, with each
    call's StageTimer(sync=True) stages; per stage the median over REPS."""
    blob = compress(x, config=CFG, device=dev)  # warm
    decompress(blob, device=dev)
    t_c, t_d, st_c, st_d = [], [], [], []
    for _ in range(REPS):
        tc, td = StageTimer(sync=True), StageTimer(sync=True)
        blob, s = _timed(lambda: compress(x, config=CFG, device=dev, timer=tc), dev)
        t_c.append(s)
        st_c.append(tc.stages)
        _y, s = _timed(lambda: decompress(blob, device=dev, timer=td), dev)
        t_d.append(s)
        st_d.append(td.stages)
    gb = x.numel() * x.element_size() / 1e9

    def medians(stages: list[dict]) -> dict:
        return {k: statistics.median(s.get(k, 0.0) for s in stages)
                for k in stages[0]}

    c, d = statistics.median(t_c), statistics.median(t_d)
    return {"blob": blob, "gbps": 2 * gb / (c + d), "compress_gbps": gb / c,
            "decompress_gbps": gb / d, "ratio": x.numel() * x.element_size() / len(blob),
            "compress": _spread(t_c), "decompress": _spread(t_d),
            "compress_stages_s": medians(st_c), "decompress_stages_s": medians(st_d)}


def _syncs_in(fn, dev: torch.device) -> list[str]:
    """The synchronizing CUDA calls one fn() makes, found by torch's sync
    debug mode, as "file:line" of the Python line that made each (paths
    relative to the repository); [] on the CPU."""
    if dev.type != "cuda":
        return []
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _sync(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    _sync(dev)
    return [f"{os.path.relpath(w.filename, root)}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def _amortized_s(fn, dev: torch.device) -> dict:
    """Per-call seconds of AMORT_K back-to-back fn() calls with one synchronize:
    between CUDA events on the card, on the host clock on the CPU; after a
    warm call, AMORT_REPS times, the median and each run."""
    fn()
    runs = []
    for _ in range(AMORT_REPS):
        _sync(dev)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(AMORT_K):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            runs.append(start.elapsed_time(end) / 1e3 / AMORT_K)
        else:
            t0 = time.perf_counter()
            for _ in range(AMORT_K):
                fn()
            runs.append((time.perf_counter() - t0) / AMORT_K)
    return {"per_call_s": statistics.median(runs), "runs_per_call_s": runs}


def amortized_encode(x: torch.Tensor, dev: torch.device) -> dict:
    """The compress() device stage as api._compress_fused_dpk runs it on
    the monolithic CFG: pad, stats, tolerance, kernels A + B and the byte
    planes (stream._encode_segment_dpk)."""
    from .ops import fused_encode

    n = x.numel()
    xp = stream._on_device(x, dev)

    def call():
        sf, _mean = api._stats_device(xp, n, CFG.sf_adj)
        tol = fused_encode.tolerance(xp, n, CFG.error_bound)
        return stream._encode_segment_dpk(xp, n, sf, tol, CFG, None, np.float32)

    return dict(_amortized_s(call, dev), syncs_per_call=_syncs_in(call, dev))


def amortized_decode(blob: bytes, dev: torch.device) -> dict:
    """The decompress() device stage of a monolithic DPK container
    (api._decode_dpk_upload: kernels N, C + D) on api._dpk_decode_prep's
    arrays, moved to the device once."""
    header, streams, _qtable, _cb = ct.parse_v2(blob)
    host_arrays, up = api._dpk_decode_prep(header, streams)
    dev_arrays, sf, _qt = api._to_device(host_arrays, header, None, dev)

    def call():
        return api._decode_dpk_upload(dev_arrays, up, sf, header.dcd)

    return dict(_amortized_s(call, dev), syncs_per_call=_syncs_in(call, dev))


def measure_sync_us(dev: torch.device) -> float | None:
    """Median microseconds of one synchronized trivial launch (bench.py's
    measure_rtt_ms); None on the CPU."""
    if dev.type != "cuda":
        return None
    s = torch.zeros((), device=dev)
    s.add_(1.0)
    _sync(dev)
    samples = []
    for _ in range(SYNC_SAMPLES):
        t0 = time.perf_counter()
        s.add_(1.0)
        torch.cuda.synchronize(dev)
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples) * 1e6


def _interval_overlap(spans, worker_kinds, dev_kinds=("device",)):
    """Measured overlap fraction of a two-stage pipeline from its spans
    (bench.py's, on records whose first four fields are name, index, start
    and end, as utils.timing.Span's): (worker_busy + device_busy -
    traced_span) / min(worker_busy, device_busy), clipped to [0, 1]; 1 =
    every second of the shorter stage hid behind the longer one, 0 =
    strictly serial. traced_span runs from the first span's start to the
    last one's end. Returns (fraction, worker_busy_s, device_busy_s)."""
    if not spans:
        return 0.0, 0.0, 0.0
    wb = sum(r[3] - r[2] for r in spans if r[0] in worker_kinds)
    db = sum(r[3] - r[2] for r in spans if r[0] in dev_kinds)
    span = max(r[3] for r in spans) - min(r[2] for r in spans)
    denom = min(wb, db)
    if denom <= 0:
        return 0.0, wb, db
    f = (wb + db - span) / denom
    return max(0.0, min(1.0, f)), wb, db


#: the DTZS spans of each direction's two stages: (worker, device)
COMPRESS_KINDS = (("pack.pull", "pack.host"), ("pipeline.encode",))
DECOMPRESS_KINDS = (("prep",), ("pipeline.decode", "copy_out"))


def _stage_spans(timer: StageTimer, kinds) -> list:
    """The timer's spans of the two stages' names, the others left out so
    that the global stats pass and the frame writes do not dilute the
    traced span."""
    names = set(kinds[0]) | set(kinds[1])
    return [s for s in timer.spans if s.name in names]


def measure_pipeline_overlap(x: torch.Tensor, dev: torch.device) -> dict:
    """One pipelined compress and restore of x in OVERLAP_SEGMENTS segments
    (the second of two runs), with the stream's spans (stream.py: the
    writer's "pipeline.encode" beside its worker's "pack.pull" and
    "pack.host"; the reader's "pipeline.decode" and "copy_out" beside its
    worker's "prep"), and per direction the overlap fraction of
    _interval_overlap."""
    se = x.numel() // OVERLAP_SEGMENTS
    for _warm in range(2):
        t_c = StageTimer()
        buf = io.BytesIO()
        _n, wall_c = _timed(lambda: stream.compress_stream(
            x, buf, config=CFG, segment_elems=se, timer=t_c, device=dev), dev)
        t_d = StageTimer()
        y, wall_d = _timed(lambda: stream.decompress_stream_all(
            stream.MemReader(buf.getvalue()), timer=t_d, device=dev), dev)
        if y.size != x.numel():
            raise RuntimeError("the traced restore lost samples")
    f_c, hb_c, db_c = _interval_overlap(_stage_spans(t_c, COMPRESS_KINDS),
                                        *COMPRESS_KINDS)
    f_d, hb_d, db_d = _interval_overlap(_stage_spans(t_d, DECOMPRESS_KINDS),
                                        *DECOMPRESS_KINDS)
    return {"compress_frac": f_c, "decompress_frac": f_d,
            "compress_worker_busy_s": hb_c, "compress_device_busy_s": db_c,
            "compress_wall_s": wall_c, "decompress_worker_busy_s": hb_d,
            "decompress_device_busy_s": db_d, "decompress_wall_s": wall_d,
            "segments": t_c.counts.get("frames", 0)}


def pipelined_model(dev_c: float, host_c: float, dev_d: float, host_d: float,
                    f_c: float, f_d: float, segments: int, gb: float) -> dict:
    """bench.py's steady state of the pipelined default path from stage
    times and overlap fractions: per direction wall = max(dev, host) + (1 -
    f) * min(dev, host) + f * min(dev, host) / S (f = 1: the ideal two-stage
    pipeline with one startup bubble; f = 0: serial)."""
    pipe_c = (max(dev_c, host_c) + (1.0 - f_c) * min(dev_c, host_c)
              + f_c * min(dev_c, host_c) / segments)
    pipe_d = (max(dev_d, host_d) + (1.0 - f_d) * min(dev_d, host_d)
              + f_d * min(dev_d, host_d) / segments)
    return {"pipelined_model_gbps": 2 * gb / (pipe_c + pipe_d),
            "compress_gbps": gb / pipe_c, "decompress_gbps": gb / pipe_d,
            "serial_sum_gbps": 2 * gb / (dev_c + host_c + dev_d + host_d),
            "device_bound_ceiling_gbps": 2 * gb / (dev_c + dev_d),
            "pipe_compress_s": pipe_c, "pipe_decompress_s": pipe_d,
            "segments": segments}


def steady_state_s(dev_s: float, packs: float, f: float, segments: int) -> float:
    """bench.py's big-point model: device compute and host packing of
    `segments` frames at the overlap fraction f."""
    return (max(dev_s, packs) + (1.0 - f) * min(dev_s, packs)
            + f * min(dev_s, packs) / max(segments, 1))


def measure_big(n: int, dev: torch.device, dev_c_per_elem: float) -> dict:
    """A device-resident BIG_FACTOR * n array through compress_stream in
    frames of min(DEFAULT_SEGMENT, its length / BIG_FRAMES), traced: the
    measured wall GB/s, the host packing, the overlap fraction and
    bench.py's modelled steady state (device stage from the amortized rate,
    pulls left out of the model as bench.py left them)."""
    n2 = BIG_FACTOR * n
    x2 = climate_formula_torch(n2, dev)
    seg = min(stream.DEFAULT_SEGMENT, n2 // BIG_FRAMES)
    timer = StageTimer()
    buf = io.BytesIO()
    (_w, wall), peak = _peak_bytes(lambda: _timed(lambda: stream.compress_stream(
        x2, buf, config=CFG, segment_elems=seg, timer=timer, device=dev), dev),
        dev)
    del x2
    nbytes = buf.getbuffer().nbytes
    f, hb, _db = _interval_overlap(_stage_spans(timer, COMPRESS_KINDS),
                                   *COMPRESS_KINDS)
    pulls = timer.stages.get("pack.pull", 0.0)
    packs = timer.stages.get("pack.host", 0.0)
    segments = timer.counts.get("frames", 0)
    gb = n2 * 4 / 1e9
    model = steady_state_s(dev_c_per_elem * n2, packs, f, segments)
    return {"n": n2, "segment_elems": seg, "segments": segments,
            "ratio": n2 * 4 / nbytes, "wall_s": wall, "wall_gbps": gb / wall,
            "host_pack_s_total": packs, "pull_s_total": pulls,
            "worker_busy_s_total": hb, "overlap_frac": f,
            "steady_state_model_gbps": gb / model, "peak_memory": peak}


def bench_native(x: np.ndarray) -> dict:
    """The C++ reference codec on the host (best of NATIVE_REPS, as
    bench.py)."""
    if not native.available():
        raise RuntimeError("the native codec (cpp/) did not build")
    t_c, t_d = [], []
    for _ in range(NATIVE_REPS):
        t0 = time.perf_counter()
        blob = native.compress(x, EB, "ec")
        t_c.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        y = native.decompress(blob)
        t_d.append(time.perf_counter() - t0)
    gb = x.nbytes / 1e9
    c, d = min(t_c), min(t_d)
    return {"gbps": 2 * gb / (c + d), "compress_gbps": gb / c,
            "decompress_gbps": gb / d, "ratio": x.nbytes / len(blob),
            "max_abs_err": float(np.abs(x - y).max()), "compress_runs_s": t_c,
            "decompress_runs_s": t_d}


def run(n: int = N, device="cuda") -> dict:
    """Every measurement of the module docstring on `device` -> the full
    record (sections by name, "last_line": the compact summary)."""
    dev = api.checked_device(device)
    t_start = time.perf_counter()
    gpu = dev.type == "cuda"
    x = climate_formula_torch(n, dev)
    _sync(dev)
    gb = n * 4 / 1e9

    head = measure_headline(x, dev)
    x_host = x.cpu().numpy()
    q = evaluate(x_host, head["y"], EB, len(head["blob"]))
    input_diff = float(np.abs(x_host - climate_formula_np(n)).max())
    mono = measure_monolithic(x, dev)
    enc = amortized_encode(x, dev)
    dec = amortized_decode(mono["blob"], dev)
    sync_us = measure_sync_us(dev)
    ovl = measure_pipeline_overlap(x, dev)
    dev_c, dev_d = enc["per_call_s"], dec["per_call_s"]
    host_c = mono["compress_stages_s"].get("zlib", 0.0)
    host_d = mono["decompress_stages_s"].get("host", 0.0)
    model = pipelined_model(dev_c, host_c, dev_d, host_d, ovl["compress_frac"],
                            ovl["decompress_frac"],
                            max(1, n // stream.DEFAULT_SEGMENT), gb)
    del x
    big = measure_big(n, dev, dev_c / n)
    base = bench_native(climate_formula_np(n))
    vs = head["gbps"] / base["gbps"]
    card = card_line() if gpu else None
    host_codec = "zstd" if entropy.zstd_available() else "zlib"
    sections = {
        "headline": {
            "gbps": head["gbps"], "compress_gbps": head["compress_gbps"],
            "decompress_gbps": head["decompress_gbps"], "compress": head["compress"],
            "decompress": head["decompress"], "reps": REPS, "frames": head["frames"],
            "ratio": q["ratio"], "bound_satisfied": q["bound_satisfied"],
            "max_rel_err": q["max_rel_err"], "psnr_db": q["psnr_db"],
            "input_max_abs_diff_vs_host_formula": input_diff,
            "note": "public API on the host clock, host-device copies "
                    "included; the bound checked on the compressed array"},
        "monolithic": {k2: v for k2, v in mono.items() if k2 != "blob"},
        "amortized": {"compress": enc, "decompress": dec, "k": AMORT_K,
                      "clock": "cuda events" if gpu else "host perf_counter",
                      "note": "syncs_per_call: the synchronizing calls inside "
                              "one call, all inside the timed window"},
        "sync_us": sync_us,
        "overlap": ovl,
        "pipelined_model": dict(model, note="a model from the amortized device "
                                "stages, the monolithic host stages (zlib, host) "
                                "and the measured overlap; not the headline"),
        "big": big,
        "peak_memory": {"headline_compress": head["peak_memory"]["compress"],
                        "headline_decompress": head["peak_memory"]["decompress"],
                        "big_compress": big.pop("peak_memory")},
        "native": base,
    }
    last = {"metric": METRIC, "value": head["gbps"], "unit": "GB/s",
            "vs_baseline": vs, "compress_gbps": head["compress_gbps"],
            "decompress_gbps": head["decompress_gbps"], "ratio": q["ratio"],
            "bound_satisfied": q["bound_satisfied"], "host_codec": host_codec,
            "platform": "gpu" if gpu else "cpu", "card": card, "n": n}
    return {"last_line": last, "sections": sections, "platform": last["platform"],
            "kind": torch.cuda.get_device_name(dev) if gpu else None, "card": card,
            "n": n, "host_codec": host_codec, "config": dataclasses.asdict(CFG_DEFAULT),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "seconds": time.perf_counter() - t_start}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dctz_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT, help="the full JSON record")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=N, help="elements (default 32Mi)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device; pass --device cpu for the CPU rehearsal",
              file=sys.stderr)
        return 2
    if args.n < 64 * OVERLAP_SEGMENTS:
        ap.error(f"--n must be at least {64 * OVERLAP_SEGMENTS}")
    rec = run(args.n, args.device)
    for name, sec in rec["sections"].items():
        print(json.dumps({"section": name, "value": sec}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    line = json.dumps(rec["last_line"])
    if len(line) > LAST_LINE_MAX:
        raise RuntimeError(f"the last line is {len(line)} bytes")
    print(line)
    return 0 if rec["last_line"]["bound_satisfied"] else 1


if __name__ == "__main__":
    sys.exit(main())
