"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up makes the cell's fields on the card from the seed, keeps them
where the traffic says, and makes one warm round trip; the window then
drives dctz_tpu_torch's public compress / decompress for --seconds seconds,
rounded up to whole cycles through the fields (harness/window.py); after
it the plain reference (reference/) judges a seeded sample of the round
trips, one of each field. --trace 1 records the window with
torch.profiler and the program's stage timer and reports the per-layer
metrics instead of the end-to-end ones.

The last stdout line is one JSON object: correct, attempted, failed,
metrics, device, [breakdown,] checks. The checks (each reading beside its
limit) are also the last lines on stderr. Without a card (or with fewer
than the cell asks for) the run exits 3 and prints no result. `--device
cpu` is the explicit CPU rehearsal at the configuration's rehearsal size:
its metrics are named "cpu_rehearsal.<name>" and it claims no device
number.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# caches of the program and its libraries stay inside the checkout; a
# library that would load JAX is told not to
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))

_FORBIDDEN = ("jax", "jaxlib", "flax", "dctz_tpu")


def _fail(code: int, msg: str):
    print(msg, file=sys.stderr)
    raise SystemExit(code)


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu: the explicit rehearsal at the rehearsal size")
    return p.parse_args(argv)


def _forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in _FORBIDDEN})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _args(argv)
    import torch

    rehearsal = args.device == "cpu"
    from benchmark.harness import spec

    cell = spec.load_cell(args.workload)
    if not rehearsal and (not torch.cuda.is_available()
                          or torch.cuda.device_count() < cell.chips):
        _fail(3, f"{args.workload} needs {cell.chips} CUDA device(s); "
                 f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import dctz_tpu_torch as dz
    except ImportError as e:
        _fail(4, f"the program under test does not import: {e}")

    config = cell.config
    codec = dict(config["codec"])
    shape = None
    if rehearsal:
        reh = config["rehearsal"]
        shape = reh["shape"]
        if "segment_elems" in reh:
            codec["segment_elems"] = reh["segment_elems"]
            config = dict(config, container=dict(config["container"],
                                                  segment_elems=reh["segment_elems"]))
    cfg = dz.CodecConfig(**codec)
    return _report(args, cell, config, cfg, *_single(args, cell, config, cfg,
                                                     shape))


def _single(args, cell, config, cfg, shape):
    """One process, one card: (run, window, readings, peak, timing)."""
    import torch

    from benchmark.harness import correct, trace, window
    from dctz_tpu_torch import api

    device = torch.device("cpu" if args.device == "cpu" else "cuda:0")
    fields = window.make_fields(cell, args.seed, device, shape)
    window.round_trip(api, fields[0], cfg, device, traced=False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    traced = bool(args.trace)
    prof = trace.profiler(device.type == "cuda") if traced else None
    if prof is not None:
        prof.__enter__()
    setup_s = time.perf_counter() - _T0
    cpu0 = time.process_time()
    try:
        w = window.measure(cell, fields, cfg, device, args.seconds, args.seed,
                           int(config["check"]["per_field"]), traced)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    # the process's CPU seconds in the window: the same work takes more of
    # them on a slower (more contended) host, which the rates then follow
    w.cpu_s = time.process_time() - cpu0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run = window.Run(setup_s, w.calls)
    t_trace = time.perf_counter()
    if traced:
        run.trace = trace.summarize(prof)
        run.work = work_of(w.firsts, w.calls, _device_name(device), cfg.verify)
    t_check = time.perf_counter()
    # the check, after the window, with the program's device state freed
    host = {k.field: correct.host_field(fields[k.field]) for k in w.kept}
    del fields
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = correct.judge(w.kept, host, config, args.seed)
    return run, w, readings, peak, (t_trace, t_check, time.perf_counter())


def _device_name(device) -> str:
    import torch

    return "cpu" if device.type == "cpu" else torch.cuda.get_device_name(device)


def _report(args, cell, config, cfg, run, w, readings, peak, timing) -> int:
    """Print the result line (and the checks, last on stderr)."""
    from benchmark.harness import spec

    rehearsal = args.device == "cpu"
    traced = run.trace is not None
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = spec.reader(m["name"])(run)
        if v is not None:
            key = ("cpu_rehearsal." + m["name"]) if rehearsal else m["name"]
            metrics[key] = {"value": v, "unit": m["unit"]}
    found = _forbidden_modules()
    if found:
        _fail(5, "modules of JAX or of the JAX package were loaded: "
                 + ", ".join(found))
    limits = config["check"]["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    failed = w.failed
    ok = all(c["value"] <= c["limit"] for c in checks.values()) and failed == 0
    import torch

    device_rec = {"platform": "cpu" if rehearsal else "gpu",
                  "kind": "cpu" if rehearsal else torch.cuda.get_device_name(0),
                  "count": 1 if rehearsal else cell.chips,
                  "memory_peak_bytes": int(peak)}
    if traced and not rehearsal:
        device_rec["busy_s"] = run.trace.busy_s
        device_rec["window_s"] = run.trace.window_s
    out = {"correct": bool(ok), "attempted": len(w.calls) // 2 + failed,
           "failed": failed, "metrics": metrics, "device": device_rec}
    if traced and not rehearsal:
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["checks"] = checks
    t_trace, t_check, t_end = timing
    print(f"seconds: set-up {run.setup_s:.2f}, window {w.seconds:.2f} (cpu "
          f"{w.cpu_s:.2f}), trace {t_check - t_trace:.2f}, check "
          f"{t_end - t_check:.2f}", file=sys.stderr)
    if "error" in readings:
        print(f"check error: {readings['error']}", file=sys.stderr)
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


def work_of(firsts: dict, calls, device_name: str, verify: bool) -> dict | None:
    """Least seconds of every traced call's work (roofline/work.py), from
    the stream sizes of each field's first container."""
    from benchmark.roofline import work

    sizes = {f: work.stream_bytes(b) for f, b in firsts.items()}
    total = {"compress": 0.0, "decompress": 0.0}
    for c in calls:
        if c.field not in sizes:
            return None
        n, streams = sizes[c.field]
        least = work.least_seconds(c.kind, n, streams, device_name, verify)
        if least is None:
            return None
        total[c.kind] += least[0]
    return total


if __name__ == "__main__":
    sys.exit(main())
