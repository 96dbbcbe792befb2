"""The device trace of a traced run (`--trace 1`), reduced to what the
per-layer readers and the breakdown need.

torch.profiler records the window (CPU and CUDA activities); its Chrome
trace is read back once: device activity is every kernel, copy and memset
("kernel", "gpu_memcpy", "gpu_memset"), and the calls and the program's
stages are the harness's profiler ranges ("bench.compress",
"bench.decompress", "stage.<name>"). Device and host timestamps share the
profiler's clock.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import pathlib
import tempfile

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Summary:
    window_s: float  # first call's start to last call's end
    busy_s: float  # device activity within it (union over streams)
    call_s: dict  # kind -> seconds inside its calls
    busy_in: dict  # kind -> device-active seconds inside its calls
    kernel_s: dict  # kind -> summed kernel time started inside its calls
    device_ops: list  # [[name, seconds]], the 10 largest
    idle_gaps: list  # [[host range open at the time, seconds]], the 10 largest


def profiler(cuda: bool):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _overlap(union, starts, s, e) -> float:
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    tot = 0.0
    while i < len(union) and union[i][0] < e:
        tot += max(0.0, min(e, union[i][1]) - max(s, union[i][0]))
        i += 1
    return tot


def _label(ranges, starts, t) -> str | None:
    """The name of the range open at t; the ranges follow one another (the
    program's stages do not nest)."""
    i = bisect.bisect_right(starts, t) - 1
    return ranges[i][2] if i >= 0 and t <= ranges[i][1] else None


def summarize(prof) -> Summary:
    """Reduce the profiler's Chrome trace (written to a temporary file under
    TMPDIR and deleted once read)."""
    fd, name = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    path = pathlib.Path(name)
    prof.export_chrome_trace(name)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    dev, calls, stages = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        name = ev.get("name", "")
        if cat in _DEVICE_CATS:
            dev.append((s, s + d, name, cat))
        elif cat == "user_annotation":
            if name.startswith("bench."):
                calls.append((s, s + d, name[6:]))
            elif name.startswith("stage."):
                stages.append((s, s + d, name[6:]))
    union = _union([(s, e) for s, e, _, _ in dev])
    ustarts = [u[0] for u in union]
    call_s, busy_in, kernel_s = (collections.Counter() for _ in range(3))
    calls.sort()
    for s, e, kind in calls:
        call_s[kind] += (e - s) * 1e-6
        busy_in[kind] += _overlap(union, ustarts, s, e) * 1e-6
    cstarts = [c[0] for c in calls]
    for s, e, name, cat in dev:
        if cat != "kernel":
            continue
        i = bisect.bisect_right(cstarts, s) - 1
        if i >= 0 and s <= calls[i][1]:
            kernel_s[calls[i][2]] += (e - s) * 1e-6
    w0 = calls[0][0] if calls else 0.0
    w1 = max((c[1] for c in calls), default=0.0)
    ops = collections.Counter()
    for s, e, name, _ in dev:
        if w0 <= s <= w1:
            ops[name] += (e - s) * 1e-6
    # idle gaps inside the window, by the innermost range open at the time
    stages.sort()
    sstarts = [r[0] for r in stages]
    gaps = collections.Counter()
    prev = w0
    for s, e in union + [[w1, w1]]:
        lo, hi = max(prev, w0), min(s, w1)
        if hi > lo:
            mid = 0.5 * (lo + hi)
            kind = _label(calls, cstarts, mid)
            stage = _label(stages, sstarts, mid)
            name = ("between calls" if kind is None
                    else f"{kind}, stage {stage}" if stage else kind)
            gaps[name] += (hi - lo) * 1e-6
        prev = max(prev, e)
    return Summary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=_overlap(union, ustarts, w0, w1) * 1e-6,
        call_s=dict(call_s), busy_in=dict(busy_in), kernel_s=dict(kernel_s),
        device_ops=[[n, s] for n, s in ops.most_common(10)],
        idle_gaps=[[n, s] for n, s in gaps.most_common(10)],
    )
