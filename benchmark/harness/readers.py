"""Arithmetic shared by the metric readers of benchmark/metrics/. A reader
returns None when its run holds nothing for it to read (an untraced run, a
stage the path does not open, a device that recorded no kernel), and the
harness then leaves the metric out of the result line."""

from __future__ import annotations


def rate_gbps(run, kind: str) -> float | None:
    calls = run.of(kind)
    secs = sum(c.seconds for c in calls)
    return sum(c.nbytes for c in calls) / secs / 1e9 if secs > 0 else None


def stage_ms(run, kind: str, stage: str) -> float | None:
    calls = [c for c in run.of(kind) if c.stages is not None]
    if not calls or not any(stage in c.stages for c in calls):
        return None
    return 1e3 * sum(c.stages.get(stage, 0.0) for c in calls) / len(calls)


def count_per_call(run, kind: str, key: str) -> float | None:
    """The program's counter `key` summed over the traced calls of `kind`,
    over their number; None when no call counted it."""
    calls = [c for c in run.of(kind) if c.counts is not None]
    if not any(key in c.counts for c in calls):
        return None
    return sum(c.counts.get(key, 0) for c in calls) / len(calls)


def idle_share(run, kind: str) -> float | None:
    t = run.trace
    if t is None or not t.busy_in.get(kind) or not t.call_s.get(kind):
        return None
    return 1.0 - t.busy_in[kind] / t.call_s[kind]


def roofline_pct(run, kind: str) -> float | None:
    t = run.trace
    if t is None or not run.work or not t.kernel_s.get(kind):
        return None
    return 100.0 * run.work[kind] / t.kernel_s[kind]
