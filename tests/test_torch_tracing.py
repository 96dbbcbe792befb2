"""The port's tracing (dctz_tpu_torch/utils/timing.py) on the CPU: the spans
and counters of the DTZS pipeline and of the monolithic container's host
entropy stage, the caller's spans tiling the API stages, the entropy
layer's CPU seconds and the parents of pool work, profiler ranges on the
caller's thread (and on every thread under device_trace), two timers on two
threads, and nothing at all when tracing is off."""

import glob
import json
import os
import tempfile
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

SEG = 1 << 14
N_DTZS = 4 * SEG  # four frames
N_MONO = 1 << 17
#: the stage keys every call of a path leaves
ENTROPY = {"zlib.sections", "zlib.container", "section.dc", "section.ac",
           "section.ids", "cpu.entropy"}
DECODE_ENTROPY = {"host.parse", "host.prep", "section.dc", "section.ac",
                  "section.ids", "cpu.entropy"}
KEYS = {
    ("dtzs", "compress"): {"pipeline", "pipeline.stats", "pipeline.encode",
                           "pipeline.wait", "pipeline.write", "pack.pull",
                           "pack.host", "sync"} | ENTROPY,
    ("dtzs", "decompress"): {"pipeline", "pipeline.wait", "pipeline.decode",
                             "copy_out", "prep", "sync"} | DECODE_ENTROPY,
    ("mono", "compress"): {"transfer", "device", "zlib", "sync"} | ENTROPY,
    ("mono", "decompress"): {"host", "transfer", "device", "sync"}
    | DECODE_ENTROPY,
}
#: each API stage and the caller's spans that tile it
TILES = {"pipeline": ("compress", "decompress"), "zlib": ("compress",),
         "host": ("decompress",)}


def _x(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=n)).astype(np.float32)


def _cfg(path, mode="ec"):
    import dctz_tpu_torch as dz

    return dz.CodecConfig(mode=mode, container="v2", ids_codec="device",
                          verify=True,
                          segment_elems=SEG if path == "dtzs" else 0)


def _round_trip(path, mode="ec", seed=0):
    """(blob, compress timer, decompress timer) of one round trip; the
    DTZS path takes a tensor, as compress() hands its writer one."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.utils.timing import StageTimer

    x = _x(N_DTZS if path == "dtzs" else N_MONO, seed)
    tc, td = StageTimer(), StageTimer()
    blob = dz.compress(torch.from_numpy(x) if path == "dtzs" else x,
                       config=_cfg(path, mode), timer=tc, device="cpu")
    y = dz.decompress(blob, timer=td, device="cpu")
    assert np.abs(y - x).max() <= 1e-3 * (x.max() - x.min())
    return blob, tc, td


@pytest.mark.parametrize("path", ["dtzs", "mono"])
def test_span_keys_on_each_path(path):
    _blob, tc, td = _round_trip(path, "qt" if path == "mono" else "ec")
    for kind, timer in (("compress", tc), ("decompress", td)):
        want = KEYS[(path, kind)]
        assert want <= set(timer.stages), want - set(timer.stages)
        assert all(v >= 0.0 for v in timer.stages.values())
        assert None not in timer.spans
    if path == "mono":
        # QT: the qtable pass runs inside "device" on the monolithic path
        assert "pipeline.qtable" not in tc.stages


def test_qtable_span_on_dtzs():
    _blob, tc, _td = _round_trip("dtzs", "qt")
    assert "pipeline.qtable" in tc.stages


def _children(timer, i):
    return [s for s in timer.spans if s.parent == i
            and s.thread == timer.spans[i].thread]


@pytest.mark.parametrize("path", ["dtzs", "mono"])
def test_caller_spans_tile_the_stages(path):
    """Every instant of the caller inside pipeline, zlib or host lies in one
    of the spans directly inside it: their seconds sum to the stage's
    within 5%, and they do not overlap."""
    _blob, tc, td = _round_trip(path)
    seen = 0
    for kind, timer in (("compress", tc), ("decompress", td)):
        for i, s in enumerate(timer.spans):
            if s.name not in TILES or kind not in TILES[s.name]:
                continue
            kids = sorted(_children(timer, i), key=lambda c: c.t0)
            assert kids, s
            assert all(b.t0 >= a.t1 for a, b in zip(kids, kids[1:]))
            assert kids[0].t0 >= s.t0 and kids[-1].t1 <= s.t1
            inner = sum(c.t1 - c.t0 for c in kids)
            assert inner >= 0.95 * (s.t1 - s.t0), (s.name, kind, inner,
                                                   s.t1 - s.t0)
            seen += 1
    assert seen == 2


@pytest.mark.cuda
def test_staged_copy_spans_on_the_copy_worker():
    """On the card the reader's copy worker opens copy_out.host, one span a
    frame with the frame's index, on its own thread under the caller's
    copy_out, and the caller's last span in the pipeline stage is the
    final drain (copy_out, no index), which every fill ends before."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the staged copy runs only there)")
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.utils.timing import StageTimer

    x = _x(N_DTZS)
    blob = dz.compress(torch.from_numpy(x).cuda(), config=_cfg("dtzs"),
                       device="cuda")
    td = StageTimer()
    y = dz.decompress(blob, timer=td, device="cuda")
    assert np.abs(y - x).max() <= 1e-3 * (x.max() - x.min())
    want = KEYS[("dtzs", "decompress")] | {"copy_out.host"}
    assert want <= set(td.stages), want - set(td.stages)
    host = [s for s in td.spans if s.name == "copy_out.host"]
    assert sorted(s.index for s in host) == list(range(N_DTZS // SEG))
    for s in host:
        parent = td.spans[s.parent]
        assert s.thread != "MainThread"
        assert parent.name == "copy_out" and parent.thread == "MainThread"
    (pipe,) = [i for i, s in enumerate(td.spans) if s.name == "pipeline"]
    last = max(_children(td, pipe), key=lambda c: c.t0)
    assert last.name == "copy_out" and last.index is None
    assert max(s.t1 for s in host) <= last.t1


@pytest.mark.parametrize("path", ["dtzs", "mono"])
def test_entropy_cpu_and_pool_parents(path):
    """cpu.entropy is positive, and every span on a pool thread names the
    span that handed its work over, on another thread."""
    _blob, tc, td = _round_trip(path)
    for timer in (tc, td):
        assert timer.stages["cpu.entropy"] > 0.0
        pool = [s for s in timer.spans if s.thread.startswith("dctz-sect")]
        assert {s.name for s in pool} >= {"section.dc", "section.ac",
                                          "section.ids"}
        for s in pool:
            assert s.parent is not None
            parent = timer.spans[s.parent]
            assert parent.thread != s.thread
            assert parent.name in ("zlib.sections", "host.prep"), parent
    if path == "dtzs":
        # the writer's and reader's workers: their spans' parents are the
        # caller's spans that handed the frame over
        for timer, name, callers in (
                (tc, "pack.pull", {"pipeline.encode", "pipeline.write"}),
                (td, "prep", {"pipeline.wait"})):
            recs = [s for s in timer.spans if s.name == name]
            assert len(recs) == N_DTZS // SEG
            for s in recs:
                p = timer.spans[s.parent]
                assert p.name in callers and p.thread == "MainThread"


def test_frames_and_syncs_are_counted():
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import stream

    blob, tc, td = _round_trip("dtzs")
    frames = 0
    r = stream.MemReader(blob)
    stream._read_stream_header(r)
    while True:
        (length,) = stream._FRAME.unpack(bytes(r.read(stream._FRAME.size)))
        if not length:
            break
        r.read(length)
        frames += 1
    assert tc.counts["frames"] == td.counts["frames"] == frames == 4
    # the host reads of pass 1 (total, max, min, sf) and each frame's
    # overflow flag; one read a frame into the output on the reader
    assert tc.counts["syncs"] == 4 + frames
    assert td.counts["syncs"] == frames
    assert len([s for s in tc.spans if s.name == "sync"]) == tc.counts["syncs"]
    # no bytes cross on the CPU device
    assert not any(k.startswith("bytes_") for k in tc.counts | td.counts)
    # the CPU device copies each frame straight into the output
    assert "frames_staged" not in td.counts
    assert "retries" not in tc.counts and "bound_shortfalls" not in tc.counts
    rep = tc.report(N_DTZS * 4)
    assert rep["counts"] == tc.counts and rep["stages_s"] == tc.stages
    assert dz.decompress(blob, device="cpu").shape == (N_DTZS,)


def test_off_makes_no_timer_and_no_range(monkeypatch):
    """No timer and no profiler: no StageTimer is made, no record_function
    entered, and the tracing module reads no clock."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.utils import timing

    made, entered = [], []
    init = timing.StageTimer.__init__

    def counting_init(self, *a, **k):
        made.append(1)
        init(self, *a, **k)

    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"time.{name} read while tracing is off")

    rf_enter = torch.autograd.profiler.record_function.__enter__

    def counting_enter(self):
        entered.append(self.name)
        return rf_enter(self)

    monkeypatch.setattr(timing.StageTimer, "__init__", counting_init)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        counting_enter)
    monkeypatch.setattr(timing, "time", NoClock())
    for path in ("dtzs", "mono"):
        x = _x(N_DTZS)
        blob = dz.compress(torch.from_numpy(x), config=_cfg(path), device="cpu")
        y = dz.decompress(blob, device="cpu")
        assert y.shape == x.shape
    assert made == [] and entered == []


def _chrome_events(path: str) -> list:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
                and e.get("name", "").startswith("stage.")]


def _profile_trace(fn) -> list:
    """fn() under a CPU profiler as the benchmark's harness starts one
    (the default: the profiling thread's ranges), its stage.* events."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    fd, name = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(name)
        return _chrome_events(name)
    finally:
        os.unlink(name)


@pytest.mark.parametrize("with_timer", [True, False])
def test_caller_ranges_in_the_profiler(with_timer):
    """Under a CPU profiler the caller's spans open stage.<name> ranges,
    with or without a timer, one after another on the caller's thread (the
    innermost span's range is the one opened last), so that the idle gaps
    of a trace take the innermost span's name."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.utils.timing import StageTimer

    x = _x(N_DTZS)
    blob = dz.compress(torch.from_numpy(x), config=_cfg("dtzs"), device="cpu")
    timer = StageTimer() if with_timer else None
    ev = _profile_trace(lambda: (
        dz.compress(torch.from_numpy(x), config=_cfg("dtzs"), timer=timer,
                    device="cpu"),
        dz.decompress(blob, timer=timer, device="cpu")))
    names = {e["name"] for e in ev}
    for n in ("pipeline", "pipeline.stats", "pipeline.encode", "pipeline.wait",
              "pipeline.write", "pipeline.decode", "copy_out", "sync"):
        assert "stage." + n in names, n
    # none ends inside another, and inside an API stage the range opened
    # last is open until the next one opens (a gap only before a stage)
    stages = {"stage.transfer", "stage.pipeline"}
    main = sorted((e for e in ev if e["tid"] == ev[0]["tid"]),
                  key=lambda e: e["ts"])
    for a, b in zip(main, main[1:]):
        assert a["ts"] + a["dur"] <= b["ts"] + b["dur"], (a, b)
        if b["ts"] > a["ts"] + a["dur"]:
            assert b["name"] in stages, (a, b)
    if with_timer:
        assert timer.counts["frames"] == 8
        # the tiles' ranges cover their stage: the stage's own range holds
        # only the instants before its first tile
        own = sum(e["dur"] for e in main if e["name"] == "stage.pipeline")
        assert own * 1e-6 < 0.02 * timer.stages["pipeline"], own


def test_device_trace_records_every_thread(tmp_path):
    """device_trace(log_dir) writes a Chrome trace into log_dir with the
    pool threads' ranges (section.*, pack.*, prep); None is a no-op."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.utils import timing

    x = _x(N_DTZS)
    with timing.device_trace(None):
        blob = dz.compress(torch.from_numpy(x), config=_cfg("dtzs"), device="cpu")
    with timing.device_trace(str(tmp_path)):
        dz.compress(torch.from_numpy(x), config=_cfg("dtzs"), device="cpu")
        dz.decompress(blob, device="cpu")
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1
    ev = _chrome_events(files[0])
    names = {e["name"] for e in ev}
    assert {"stage.section.dc", "stage.section.ac", "stage.section.ids",
            "stage.pack.host", "stage.prep", "stage.pipeline.wait"} <= names
    assert len({e["tid"] for e in ev}) > 2


def test_two_threads_two_timers():
    """Two callers on two threads, each with its own timer, at once: each
    timer holds its own call's spans and counters only."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.utils.timing import StageTimer

    xs = [_x(N_DTZS, 1), _x(2 * N_DTZS, 2)]
    timers = [StageTimer(), StageTimer()]
    names = ["caller-0", "caller-1"]
    barrier = threading.Barrier(2)
    errors = []

    def work(k):
        try:
            barrier.wait(timeout=60)
            for _ in range(2):
                blob = dz.compress(torch.from_numpy(xs[k]), config=_cfg("dtzs"),
                                   timer=timers[k], device="cpu")
                dz.decompress(blob, timer=timers[k], device="cpu")
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,), name=names[k])
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for k, timer in enumerate(timers):
        frames = 2 * 2 * (k + 1) * N_DTZS // SEG  # two round trips
        assert timer.counts["frames"] == frames
        assert len([s for s in timer.spans if s.name == "pipeline.encode"]) \
            == frames // 2
        callers = {s.thread for s in timer.spans if s.name.startswith("pipeline")}
        assert callers == {names[k]}
        # every span descends from one of this caller's own stages
        for s in timer.spans:
            while s.parent is not None:
                s = timer.spans[s.parent]
            assert s.name in ("transfer", "pipeline") and s.thread == names[k]


def test_print_report_and_counts(capsys):
    from dctz_tpu_torch.utils.timing import StageTimer

    _blob, tc, _td = _round_trip("dtzs")
    tc.print_report(N_DTZS * 4, label="c: ")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("c: ") and "pipeline.wait=" in out[0]
    assert "frames=4" in out[1]
    t = StageTimer()
    with t:
        with t.stage("device"):
            pass
    t.print_report(1000)
    assert "rate = " in capsys.readouterr().out


def test_nested_call_without_timer_records_nothing_into_the_caller():
    """rate="auto" trials compress with no timer inside the caller's
    "rate" stage: none of their spans or counters land in its timer."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.utils.timing import StageTimer

    timer = StageTimer()
    x = _x(N_MONO)
    dz.compress(x, config=dz.CodecConfig(container="v2", rate="auto",
                                         segment_elems=0),
                timer=timer, device="cpu")
    rate = [i for i, s in enumerate(timer.spans) if s.name == "rate"]
    assert len(rate) == 1 and timer.rate_trials
    assert not any(s.parent == rate[0] for s in timer.spans)
    assert len([s for s in timer.spans if s.name == "zlib"]) == 1
