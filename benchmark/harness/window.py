"""Set-up and the measured window of one cell.

The window is a closed loop with one caller, a simulation's writer or an
analysis reader waiting on each call: it takes the snapshot's fields in
the traffic's order, cycling, and for each calls the public API's
compress(field, config=cfg) and then decompress(blob), each timed on the
host clock. It runs whole cycles, the first that starts after --seconds
ending it, so that the rates weigh every field alike (the fields' costs
differ by up to three times). Both calls return host objects (bytes, a numpy array), so each
time covers finished work. A seeded reservoir of each field keeps the blob
and output of one of its round trips (or `per_field`) for the correctness
check after the window, so that every field's path is judged in every run;
the rest are dropped as soon as they are timed. Nothing is written to
disk.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import random
import time
import traceback

import numpy as np
import torch


@dataclasses.dataclass
class Call:
    kind: str  # "compress" | "decompress"
    field: int
    seconds: float
    nbytes: int  # the array's bytes (input of compress, output of decompress)
    blob_bytes: int  # the container's bytes
    stages: dict | None = None  # StageTimer seconds (traced runs)
    counts: dict | None = None  # StageTimer counters (traced runs)


@dataclasses.dataclass
class Kept:
    iteration: int
    field: int
    blob: bytes
    out: np.ndarray


@dataclasses.dataclass
class Run:
    """Everything the metric readers see."""

    setup_s: float
    calls: list
    trace: object = None  # trace.Summary of a traced run
    work: dict | None = None  # roofline least seconds per kind, traced runs

    def of(self, kind: str) -> list:
        return [c for c in self.calls if c.kind == kind]


def make_fields(cell, seed: int, device: torch.device, shape=None):
    """The snapshot's fields, made on the device from the seed, then kept
    where the traffic says: "device" (CUDA tensors, an in-situ writer) or
    "host" (pageable numpy arrays, read back once)."""
    from ..data import grf

    cfg = cell.config
    out = []
    for i in range(len(cfg["fields"])):
        f = grf.make_field(cfg, i, seed, device, shape)
        if cell.traffic["residency"] == "host":
            f = f.cpu().numpy()
        out.append(f)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def order(cell, n_fields: int) -> list[int]:
    names = [f["name"] for f in cell.config["fields"]]
    want = cell.traffic.get("order", "config")
    return list(range(n_fields)) if want == "config" else [names.index(n) for n in want]


@functools.lru_cache(maxsize=1)
def _labelled_timer_class():
    from dctz_tpu_torch.utils.timing import StageTimer

    class LabelledTimer(StageTimer):
        """A synchronizing StageTimer whose stages also open a profiler
        range ("stage.<name>"), so the trace can say what the host was
        doing."""

        @contextlib.contextmanager
        def stage(self, name):
            with torch.profiler.record_function("stage." + name):
                with super().stage(name):
                    yield

    return LabelledTimer


def labelled_timer():
    return _labelled_timer_class()(sync=True)


def no_range(_name: str):
    return contextlib.nullcontext()


def round_trip(api, x, cfg, device, traced: bool):
    """One compress and one decompress through the public API:
    (blob, out, compress s, decompress s, compress timer, decompress
    timer); the timers are None on an untraced run."""
    tc = labelled_timer() if traced else None
    td = labelled_timer() if traced else None
    rf = torch.profiler.record_function if traced else no_range
    t0 = time.perf_counter()
    with rf("bench.compress"):
        blob = api.compress(x, config=cfg, timer=tc, device=device)
    t1 = time.perf_counter()
    with rf("bench.decompress"):
        out = api.decompress(blob, timer=td, device=device)
    t2 = time.perf_counter()
    return blob, out, t1 - t0, t2 - t1, tc, td


def timer_record(timer) -> tuple:
    """(stages, counts) of a call's timer; (None, None) untraced."""
    return (None, None) if timer is None else (timer.stages, timer.counts)


def keep(kept: dict, seen: dict, rng: random.Random, per_field: int,
         item: Kept) -> None:
    """Offer a round trip to its field's seeded reservoir of `per_field`
    (kept: field -> its reservoir; seen: field -> its round trips so far)."""
    f = item.field
    k = seen[f]
    seen[f] = k + 1
    slot = k if k < per_field else rng.randrange(k + 1)
    if slot < per_field:
        if slot < len(kept[f]):
            kept[f][slot] = item
        else:
            kept[f].append(item)


@dataclasses.dataclass
class Window:
    calls: list
    kept: list  # the reservoirs' round trips, field by field
    firsts: dict  # field -> its first blob (traced runs: the roofline's sizes)
    failed: int  # round trips that raised
    seconds: float
    cpu_s: float = 0.0  # the process's CPU seconds in the window


def measure(cell, fields, cfg, device, seconds: float, seed: int,
            per_field: int, traced: bool) -> Window:
    from dctz_tpu_torch import api

    seq = order(cell, len(fields))
    rng = random.Random(int(seed) ^ 0x5EED)
    w = Window([], [], {}, 0, 0.0)
    kept = {f: [] for f in seq}  # field -> its reservoir
    seen = dict.fromkeys(seq, 0)  # field -> its round trips so far
    start = time.perf_counter()
    i = 0
    # whole cycles: every field written and read as often as the others
    while time.perf_counter() - start < seconds or i % len(seq):
        f = seq[i % len(seq)]
        x = fields[f]
        nbytes = x.numel() * 4 if isinstance(x, torch.Tensor) else x.nbytes
        try:
            blob, out, sc, sd, tc, td = round_trip(api, x, cfg, device,
                                                   traced)
        except Exception:  # a failed call is counted, reported and judged
            w.failed += 1
            if w.failed == 1:
                traceback.print_exc()
            i += 1
            continue
        w.calls.append(Call("compress", f, sc, nbytes, len(blob),
                            *timer_record(tc)))
        w.calls.append(Call("decompress", f, sd, out.nbytes, len(blob),
                            *timer_record(td)))
        if traced and f not in w.firsts:
            w.firsts[f] = blob
        keep(kept, seen, rng, per_field, Kept(i, f, blob, out))
        del blob, out
        i += 1
    w.seconds = time.perf_counter() - start
    w.kept = [item for f in sorted(kept) for item in kept[f]]
    return w
