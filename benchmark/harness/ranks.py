"""A cell of several ranks: one process a card, the ranks of one deployment
writing and restoring each field together through
dctz_tpu_torch.parallel.multihost.

run.py's process is rank 0. It starts ranks 1 .. chips - 1 on the same
host (`python3 -m benchmark.harness.ranks --rank r ...`, with RANK,
WORLD_SIZE, MASTER_ADDR=127.0.0.1 and a free MASTER_PORT), rank r on
cuda:r under NCCL (`--device cpu`: gloo ranks on the CPU), and gives each
rank an equal, disjoint share of its CPUs (sched_setaffinity on every
thread, as many torch threads), as mpirun binds ranks. Before it starts
them it builds the program's libraries, so that a checkout's first run
does not build them four times into one directory.

Set-up: every rank makes each field whole from the seed (data/grf.py) and
keeps only its multihost.host_slice, where the traffic's residency says:
"host", a pageable numpy slab; "device", a tensor on the rank's own card
(cuda:r), handed to compress_multihost as it is (under --device cpu a
numpy slab either way: compress_multihost takes no CPU tensor). One warm
round trip follows.

The window is a closed loop over whole cycles of the fields in the
traffic's order. For each field, after a barrier every rank times
compress_multihost(slab) on the host clock; the ranks' parts are gathered
in rank order into one DTZS stream, untimed (it stands for the parallel
file system); after a second barrier every rank times
decompress_multihost(stream). A call's seconds are the slowest rank's; its
bytes are the whole field's and the whole stream's, so the one-card
readers of the rates, the ratio and the set-up read it unchanged. Rank 0
decides the window's end and broadcasts it. A call that raises ends the
run: the other ranks would wait in its collective.

After the window the seeded reservoir's round trips (window.py's: one a
field) are gathered to rank 0, untimed: the stream and the ranks' restored
slabs. Rank 0 remakes each kept field from the seed and judges the whole
field, the whole stream and the joined restore with correct.judge. A
traced run profiles every rank alike: busy_s and window_s are the ranks'
mean, and the per-layer metrics read rank 0's card and rank 0's frame.
It also traces each rank's compress_multihost and decompress_multihost
into a fresh StageTimer(sync=True) (dctz_tpu_torch.utils.timing.using:
the program's spans and counters of code handed no timer); rank 0's
stages and counts go into its calls, as window.Call's do.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import random
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from . import spec, window


@dataclasses.dataclass
class RankCall(window.Call):
    rank_seconds: tuple = ()  # every rank's host seconds, in rank order


def skew_ms(run, kind: str) -> float | None:
    """The slowest rank's seconds less the ranks' mean, in ms, averaged over
    the calls of `kind`: the time a collective call waits on its slowest
    rank. None for a run of one rank."""
    calls = [c for c in run.of(kind) if len(getattr(c, "rank_seconds", ())) > 1]
    if not calls:
        return None
    return 1e3 * sum(max(c.rank_seconds) - sum(c.rank_seconds) / len(c.rank_seconds)
                     for c in calls) / len(calls)


def cpu_shares(cpus, world: int) -> list[list[int]]:
    """An equal, disjoint share of `cpus` for each rank (one CPU each, in
    turn, where there are fewer CPUs than ranks)."""
    cpus = sorted(cpus)
    if len(cpus) < world:
        return [[cpus[r % len(cpus)]] for r in range(world)]
    per = len(cpus) // world
    return [cpus[r * per:(r + 1) * per] for r in range(world)]


def _bind(cpus) -> None:
    """Every thread of this process on `cpus`, and as many torch threads."""
    import torch

    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except ProcessLookupError:  # a thread that has ended meanwhile
            pass
    torch.set_num_threads(len(cpus))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _forwarded(args) -> list[str]:
    return ["--workload", args.workload, "--seed", str(args.seed),
            "--seconds", repr(args.seconds), "--trace", str(args.trace),
            "--device", args.device]


def _watch_ranks(procs, done: threading.Event) -> None:
    """Rank 0's watchdog: a rank that exits with an error ends the run (the
    others would wait for it in a collective)."""
    while not done.wait(0.5):
        for r, p in enumerate(procs, 1):
            rc = p.poll()
            if rc not in (None, 0):
                print(f"rank {r} exited with code {rc}; ending the run",
                      file=sys.stderr, flush=True)
                for q in procs:
                    q.kill()
                os._exit(6)


def _watch_parent(ppid: int) -> None:
    """A spawned rank's watchdog: it ends when rank 0 has gone."""
    while os.getppid() == ppid:
        time.sleep(1.0)
    os._exit(7)


def run(args, cell, config, cfg, shape, t0: float):
    """Rank 0 (run.py's process): start the other ranks, run this rank, and
    return run.py's (run, window, readings, peak, timing) for its report."""
    world = cell.chips
    cpus = sorted(os.sched_getaffinity(0))
    shares = cpu_shares(cpus, world)
    if args.device == "cuda":
        from dctz_tpu_torch.kernels import build

        build.build()
    from dctz_tpu_torch import native

    native.available()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      WORLD_SIZE=str(world), RANK="0")
    procs = []
    done = threading.Event()
    try:
        for r in range(1, world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.harness.ranks", "--rank", str(r),
                 "--cpus", ",".join(map(str, shares[r])), *_forwarded(args)],
                cwd=spec.ROOT, env=dict(os.environ, RANK=str(r)),
                stdin=subprocess.DEVNULL, stdout=2))
        threading.Thread(target=_watch_ranks, args=(procs, done),
                         daemon=True).start()
        _bind(shares[0])
        result, w, peak, t_trace = _rank(0, world, args, cell, config, cfg,
                                         shape, t0)
        done.set()
        for r, p in enumerate(procs, 1):
            if p.wait(timeout=120) != 0:
                raise SystemExit(f"rank {r} exited with code {p.returncode}")
    finally:
        done.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    t_check = time.perf_counter()
    readings = _judge(w.kept, args, config, shape, cpus)
    return result, w, readings, peak, (t_trace, t_check, time.perf_counter())


def _judge(kept, args, config, shape, cpus) -> dict:
    """The check, once the window has closed, the peak has been read and
    the other ranks have ended: rank 0, on every CPU of the launcher,
    remakes each kept field whole from the seed and judges it."""
    import torch

    from ..data import grf
    from . import correct

    _bind(cpus)
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    host = {k.field: correct.host_field(
        grf.make_field(config, k.field, args.seed, device, shape)) for k in kept}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return correct.judge(kept, host, config, args.seed)


def _sizes(n: int, world: int, group) -> list[int]:
    """Every rank's `n`, in rank order."""
    import torch
    import torch.distributed as dist

    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([n], dtype=torch.int64), group=group)
    return [int(s) for s in sizes]


def _assemble(part: bytes, world: int, group) -> bytes:
    """The ranks' parts joined in rank order: every rank gets the stream."""
    import torch
    import torch.distributed as dist

    lens = _sizes(len(part), world, group)
    buf = np.zeros(max(lens), np.uint8)
    buf[:len(part)] = np.frombuffer(part, np.uint8)
    outs = [torch.empty(max(lens), dtype=torch.uint8) for _ in range(world)]
    dist.all_gather(outs, torch.from_numpy(buf), group=group)
    return b"".join(o[:k].numpy().tobytes() for o, k in zip(outs, lens))


def _gather_to_0(x: np.ndarray, length: int, rank: int, world: int, group):
    """Every rank's `x` (at most `length` samples) joined on rank 0."""
    import torch
    import torch.distributed as dist

    lens = _sizes(x.size, world, group)
    buf = torch.zeros(length, dtype=torch.float32)
    buf[:x.size] = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    outs = ([torch.empty(length, dtype=torch.float32) for _ in range(world)]
            if rank == 0 else None)
    dist.gather(buf, outs, dst=0, group=group)
    if rank:
        return None
    return np.concatenate([o[:k].numpy() for o, k in zip(outs, lens)])


def _rank(rank, world, args, cell, config, cfg, shape, t0):
    """One rank's set-up and window. Rank 0 returns (run, window with the
    joined round trips, the largest rank's peak, the trace's start); the
    others None."""
    import torch
    import torch.distributed as dist

    from dctz_tpu_torch.ops import idpack
    from dctz_tpu_torch.parallel import multihost as mh
    from dctz_tpu_torch.utils import timing

    from ..data import grf
    from ..reference import container as rct
    from . import trace

    cuda = args.device == "cuda"
    mh.init(backend="nccl" if cuda else "gloo")
    group = dist.new_group(backend="gloo") if cuda else None  # host collectives
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    mesh = None if cuda else ["cpu"]
    n_total = math.prod(shape or config["shape"])
    quantum = idpack.B_DEFAULT if cfg.ids_codec in ("device", "auto") else 1
    lo, hi = mh.host_slice(n_total, cfg.block_size, quantum, mesh)
    share = hi - lo
    on_device = cell.traffic["residency"] == "device"
    slabs = []
    for i in range(len(config["fields"])):
        f = grf.make_field(config, i, args.seed, device, shape)
        slab = f[lo:min(hi, n_total)]
        slabs.append(slab.clone() if on_device and cuda
                     else slab.to("cpu", copy=True).numpy())
        del f, slab
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    seq = window.order(cell, len(slabs))
    traced = bool(args.trace)
    rf = torch.profiler.record_function if traced else window.no_range

    def barrier():
        dist.barrier(group=group)

    def round_trip(slab, traced=False):
        tc = timing.StageTimer(sync=True) if traced else None
        td = timing.StageTimer(sync=True) if traced else None
        barrier()
        a = time.perf_counter()
        with rf("bench.compress"), timing.using(tc):
            part = mh.compress_multihost(slab, n_total, config=cfg, mesh=mesh)
        b = time.perf_counter()
        stream = _assemble(part, world, group)
        barrier()
        c = time.perf_counter()
        with rf("bench.decompress"), timing.using(td):
            restored = mh.decompress_multihost(stream, mesh=mesh)
        d = time.perf_counter()
        return stream, restored.data, b - a, d - c, tc, td

    round_trip(slabs[seq[0]])
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    barrier()
    prof = trace.profiler(cuda) if traced else None
    if prof is not None:
        prof.__enter__()
    setup_s = time.perf_counter() - t0
    cpu0 = time.process_time()
    per_field = int(config["check"]["per_field"])
    rng = random.Random(int(args.seed) ^ 0x5EED)  # as window.measure seeds it
    kept = {f: [] for f in seq}
    seen = dict.fromkeys(seq, 0)
    times, firsts = [], {}
    go = torch.zeros(1, dtype=torch.int32)
    start = time.perf_counter()
    i = 0
    try:
        while True:
            if rank == 0:  # whole cycles, as window.measure runs them
                go[0] = int(time.perf_counter() - start < args.seconds
                            or i % len(seq) != 0)
            dist.broadcast(go, src=0, group=group)
            if not go[0]:
                break
            f = seq[i % len(seq)]
            stream, out, sc, sd, tc, td = round_trip(slabs[f], traced)
            times.append((f, sc, sd, len(stream), tc, td))
            if traced and rank == 0 and f not in firsts:
                firsts[f] = bytes(rct.frames(stream)[1][0])  # rank 0's frame
            window.keep(kept, seen, rng, per_field,
                        window.Kept(i, f, stream if rank == 0 else b"", out))
            del stream, out
            i += 1
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    seconds = time.perf_counter() - start
    cpu_s = time.process_time() - cpu0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    from benchmark import run as bench_run

    found = bench_run._forbidden_modules()
    if found:
        raise SystemExit(f"rank {rank}: modules of JAX or of the JAX package "
                         "were loaded: " + ", ".join(found))
    t_trace = time.perf_counter()
    summary = trace.summarize(prof) if traced else None
    # every rank's times, peak, CPU seconds and trace reading, on every rank
    mine = {"times": [(sc, sd) for _, sc, sd, *_ in times], "peak": peak,
            "cpu_s": cpu_s, "busy": summary and (summary.busy_s, summary.window_s)}
    everyone = [None] * world
    dist.all_gather_object(everyone, mine, group=group)
    items = [item for f in sorted(kept) for item in kept[f]]
    joined = [_gather_to_0(item.out, share, rank, world, group) for item in items]
    del slabs
    if cuda:
        torch.cuda.empty_cache()
    if rank:
        dist.destroy_process_group()
        return None

    calls = []
    for j, (f, _, _, blob_bytes, tc, td) in enumerate(times):
        rc = tuple(e["times"][j][0] for e in everyone)
        rd = tuple(e["times"][j][1] for e in everyone)
        nbytes = n_total * 4
        calls.append(RankCall("compress", f, max(rc), nbytes, blob_bytes,
                              *window.timer_record(tc), rank_seconds=rc))
        calls.append(RankCall("decompress", f, max(rd), nbytes, blob_bytes,
                              *window.timer_record(td), rank_seconds=rd))
    w = window.Window(calls, [dataclasses.replace(item, out=out)
                              for item, out in zip(items, joined)],
                      firsts, 0, seconds, sum(e["cpu_s"] for e in everyone))
    result = window.Run(setup_s, calls)
    if traced:
        busy = [e["busy"] for e in everyone]
        result.trace = dataclasses.replace(
            summary, busy_s=sum(b[0] for b in busy) / world,
            window_s=sum(b[1] for b in busy) / world)
        result.work = bench_run.work_of(firsts, calls,
                                        bench_run._device_name(device),
                                        cfg.verify)
    dist.destroy_process_group()
    return result, w, max(e["peak"] for e in everyone), t_trace


def main(argv=None) -> int:
    """A spawned rank (1 .. chips - 1): bind, run, exit."""
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--cpus", required=True)
    own, rest = p.parse_known_args(argv)
    ppid = os.getppid()
    threading.Thread(target=_watch_parent, args=(ppid,), daemon=True).start()
    from benchmark import run as bench_run

    args = bench_run._args(rest)
    _bind([int(c) for c in own.cpus.split(",")])
    cell = spec.load_cell(args.workload)
    config, cfg, shape = bench_run.setting(cell, args.device == "cpu")
    _rank(own.rank, cell.chips, args, cell, config, cfg, shape,
          time.perf_counter())
    return 0


if __name__ == "__main__":
    sys.exit(main())
