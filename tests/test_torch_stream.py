"""The port's DTZS stream container (dctz_tpu_torch/stream.py) against
dctz_tpu/stream.py, EC and QT, at n = 4 * 16384 + 1025 in segments of
2 * 16384 (three frames, the last one padded): streams decode both ways,
the port's streamed decode is bit-equal to its monolithic decode, the frame
headers match the reference's (n and sf exact, the qtable within 4 ulp, the
mean exact from a numpy input and within the ulp budget of
test_torch_oracle.MEAN_ULPS from a tensor), QT's slot 0 holds each frame's
last real block's DC, broken streams raise, and numpy and tensor inputs
write the same sections, each route with the reference's mean of that
route."""

import io

import numpy as np
import pytest
import torch

from test_torch_oracle import (  # noqa: F401
    EPS32, TILE_N, assert_mean_close, bound, oracle, slice_cfg,
)
from test_torch_qt import qt_signal

torch.set_num_threads(2)

N = 4 * TILE_N + 1025
SEG = 2 * TILE_N
MODES = ["ec", "qt"]
#: the writer's two routes for the global statistics: a numpy input sums
#: float64 segment sums on the host, a tensor (the JAX package: a device
#: array) takes a float32 sum on its device
ROUTES = ["host", "device"]


def _x():
    return qt_signal(N, 21)


def _port_stream(mode, x=None, config=None, **kw):
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import stream

    buf = io.BytesIO()
    stream.compress_stream(_x() if x is None else x, buf,
                           config=config or slice_cfg(dz, mode=mode),
                           segment_elems=SEG, device="cpu", **kw)
    return buf.getvalue()


def _frames(raw: bytes):
    """The v2 containers of a DTZS stream, in order."""
    from dctz_tpu_torch import stream

    off, out = stream._HDR.size, []
    while True:
        (flen,) = stream._FRAME.unpack_from(raw, off)
        off += stream._FRAME.size
        if not flen:
            return out
        out.append(raw[off : off + flen])
        off += flen


@pytest.fixture(scope="module")
def ref_streams(oracle):
    """dctz_tpu's streams of the same input (the fused DPK segment path),
    by mode and by the route of its statistics: out[mode] from the numpy
    input, out[mode, "device"] from a JAX array."""
    import dctz_tpu
    import jax.numpy as jnp
    from dctz_tpu import stream as jstream

    out = {}
    for mode in MODES:
        for route, x in (("host", _x()), ("device", jnp.asarray(_x()))):
            buf = io.BytesIO()
            jstream.compress_stream(x, buf, config=slice_cfg(dctz_tpu, mode=mode),
                                    segment_elems=SEG)
            out[mode if route == "host" else (mode, route)] = buf.getvalue()
    return out


def _port_stream_of(mode, route):
    x = _x()
    return _port_stream(mode, x if route == "host" else torch.from_numpy(x))


@pytest.mark.parametrize("mode", MODES)
def test_port_stream_decodes_in_reference(ref_streams, mode):
    import dctz_tpu

    x = _x()
    y = np.asarray(dctz_tpu.decompress(_port_stream(mode)))
    assert y.shape == x.shape and np.abs(y - x).max() <= bound(x)


@pytest.mark.parametrize("mode", MODES)
def test_reference_stream_decodes_in_port(ref_streams, mode):
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import container as ct

    x = _x()
    raw = ref_streams[mode]
    ref = np.asarray(dctz_tpu.decompress(raw))
    got = dz.decompress(raw, device="cpu")
    assert got.shape == x.shape and np.abs(got - x).max() <= bound(x)
    sf = ct.parse_v2(_frames(raw)[0])[0].scaling_factor
    assert np.abs(got - ref).max() <= 32 * EPS32 * sf


@pytest.mark.parametrize("mode", MODES)
def test_streamed_decode_equals_monolithic(mode):
    import dctz_tpu_torch as dz

    x = _x()
    y_stream = dz.decompress(_port_stream(mode), device="cpu")
    mono = dz.compress(x, config=slice_cfg(dz, mode=mode), device="cpu")
    assert mono[:4] != b"DTZS"
    assert y_stream.tobytes() == dz.decompress(mono, device="cpu").tobytes()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("mode", MODES)
def test_frame_headers_match_reference(ref_streams, mode, route):
    """n, sf, mode and the DPK flag exact, the qtable within 4 ulp; the
    mean, total / n unrounded as the reference stores it: exact on the host
    route (the same float64 segment sums), within the ulp budget on the
    device route (a float32 sum in another order)."""
    from dctz_tpu_torch.core import container as ct

    key = mode if route == "host" else (mode, route)
    got, ref = _frames(_port_stream_of(mode, route)), _frames(ref_streams[key])
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        hg, _s, qg, _c = ct.parse_v2(g)
        hr, _s, qr, _c = ct.parse_v2(r)
        assert (hg.num_elements, hg.scaling_factor, hg.mode, hg.dpk) == (
            hr.num_elements, hr.scaling_factor, hr.mode, hr.dpk)
        if route == "host":
            assert hg.mean == hr.mean
        else:
            assert_mean_close(hg, hr, _x())
        assert (qg is None) == (qr is None) == (mode == "ec")
        if qg is not None:
            ulps = np.abs(qg[1:] - qr[1:]) / np.spacing(np.abs(qr[1:]))
            assert ulps.max() <= 4 and (qr[1:] > 1.0).any()


def test_qt_slot0_is_each_frames_last_real_block_dc():
    """Slot 0 of every frame's qtable is the DC of its last real block,
    not of a zero pad block (the tail frame holds 1025 samples, padded to
    2048); slots >= 1 are the same global table in every frame."""
    from torch_common import host_padded_arrays

    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import container as ct

    frames = _frames(_port_stream("qt"))
    tables = []
    for blob in frames:
        header, streams, qtable, _cb = ct.parse_v2(blob)
        (_w, _r, _e, dc, _ac), _meta = host_padded_arrays(header, streams)
        dc = api._combine_planes(torch.from_numpy(np.array(dc))).numpy()
        last = -(-header.num_elements // 64) - 1
        assert qtable[0] == dc[last] != 0.0
        tables.append(qtable)
    assert ct.parse_v2(frames[-1])[0].num_elements == 1025
    for t in tables[1:]:
        assert t[1:].tobytes() == tables[0][1:].tobytes()


def _cut(raw, what):
    if what == "magic":
        return b"XTZS" + raw[4:]
    if what == "header":
        return raw[:10]
    if what == "frame":
        return raw[: len(raw) // 2]
    return raw[:-8]  # the end marker


@pytest.mark.parametrize("what,match", [
    ("magic", "not a DCTZ-TPU stream"),
    ("header", "truncated stream"),
    ("frame", "truncated stream"),
    ("end", "truncated stream"),
])
def test_broken_streams_raise(what, match):
    from dctz_tpu_torch import stream

    raw = _cut(_port_stream("ec"), what)
    with pytest.raises(ValueError, match=match):
        stream.decompress_stream_all(stream.MemReader(raw), device="cpu")


@pytest.mark.parametrize("ahead", [1, 2])
@pytest.mark.parametrize("fault", ["cut", "crc"])
def test_reader_meets_a_fault_where_one_frame_ahead_does(fault, ahead):
    """However many frames the reader preps at once (its `ahead`; a CUDA
    device takes stream.PREP_AHEAD), it meets a fault in frame k of five
    where a reader that reads one frame ahead does: a frame cut short fails
    the wait for frame k - 1 (frames 0 to k - 2 restored), a crc mismatch
    the wait for frame k (frames 0 to k - 1 restored)."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import stream
    from dctz_tpu_torch.utils import timing
    from torch_common import frame_spans

    buf = io.BytesIO()
    stream.compress_stream(_x(), buf, config=slice_cfg(dz, mode="ec"),
                           segment_elems=TILE_N, device="cpu")
    raw = buf.getvalue()
    spans = frame_spans(raw)
    assert len(spans) == 5
    for k, (start, end) in enumerate(spans):
        if fault == "cut":
            bad, want = raw[: (start + end) // 2], max(k - 1, 0)
        else:
            bad = bytearray(raw)
            bad[(start + end) // 2] ^= 0x5A
            bad, want = bytes(bad), k
        f = io.BytesIO(bad)
        stream._read_stream_header(f)
        got = []
        with pytest.raises(ValueError):
            for n, dtype, run in stream._frame_stages(
                    f, timing.OFF, torch.device("cpu"), ahead=ahead):
                got.append(run(np.empty(n, dtype)))
        assert len(got) == want, (k, len(got))


@pytest.mark.parametrize("mode", MODES)
def test_numpy_and_tensor_inputs_write_the_same_stream(ref_streams, mode):
    """A numpy input and a tensor input write the same sections in every
    frame; their headers' means differ as the reference's two routes do:
    each frame's mean is that of the reference's stream of the same route
    (exact from numpy; from a tensor within the ulp budget, and the
    reference's own two routes differ)."""
    from dctz_tpu_torch.core import container as ct

    host, dev = _frames(_port_stream(mode)), _frames(_port_stream_of(mode, "device"))
    ref_h, ref_d = _frames(ref_streams[mode]), _frames(ref_streams[mode, "device"])
    assert len(host) == len(dev) == 3
    for h, d, rh, rd in zip(host, dev, ref_h, ref_d):
        (hh, sh, qh, _c), (hd, sd, qd, _c) = ct.parse_v2(h), ct.parse_v2(d)
        assert [bytes(b"".join(c)) for c in sh] == [bytes(b"".join(c)) for c in sd]
        assert (qh is None) == (qd is None) and (qh is None or qh.tobytes() == qd.tobytes())
        assert hh.mean == ct.parse_v2(rh)[0].mean
        assert_mean_close(hd, ct.parse_v2(rd)[0], _x())
    assert ct.parse_v2(ref_h[0])[0].mean != ct.parse_v2(ref_d[0])[0].mean


def test_compress_routes_to_the_stream(monkeypatch):
    """segment_elems routes compress() to the stream writer (an int, or
    "auto" from stream.AUTO_THRESHOLD elements on) under a "pipeline"
    stage, and decompress() detects the stream."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import api, stream
    from dctz_tpu_torch.utils.timing import StageTimer

    x = _x()
    explicit = dz.compress(x, config=slice_cfg(dz, segment_elems=SEG), device="cpu")
    # compress() hands the stream writer a tensor: the device route's mean
    assert explicit == _port_stream_of("ec", "device")
    monkeypatch.setattr(stream, "AUTO_THRESHOLD", N)
    monkeypatch.setattr(stream, "DEFAULT_SEGMENT", SEG)
    timer = StageTimer()
    auto = dz.compress(x, config=slice_cfg(dz, segment_elems="auto"),
                       device="cpu", timer=timer)
    assert auto == explicit and "pipeline" in timer.stages
    assert api._resolve_segment(slice_cfg(dz, segment_elems="auto"), N - 1) is None
    assert api._resolve_segment(slice_cfg(dz, segment_elems=SEG), 2 * SEG - 1) is None
    assert api._resolve_segment(slice_cfg(dz, mode="qt", segment_elems="auto"), N) == SEG
    timer = StageTimer()
    y = dz.decompress(memoryview(auto), device="cpu", timer=timer)
    assert "pipeline" in timer.stages and np.abs(y - x).max() <= bound(x)


def test_trace_covers_every_segment():
    """The writer's and reader's timers hold one span of each per-frame
    kind for every frame, in frame order."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import stream
    from dctz_tpu_torch.utils.timing import StageTimer

    enc, dec = StageTimer(), StageTimer()
    raw = _port_stream("qt", timer=enc)
    list(stream.decompress_stream(io.BytesIO(raw), timer=dec, device="cpu"))
    for timer, kinds in ((enc, ("pipeline.encode", "pack.pull", "pack.host")),
                         (dec, ("prep", "pipeline.decode", "copy_out"))):
        for kind in kinds:
            spans = [s for s in timer.spans if s.name == kind]
            assert [s.index for s in spans] == [0, 1, 2]
            assert all(s.t1 >= s.t0 for s in spans)
        assert timer.counts["frames"] == 3
    assert dz.decompress(raw, device="cpu").shape == (N,)


def test_generic_segment_path_writes_host_coded_frames():
    """ids_codec "deflate" takes the generic segment path: host-coded v2
    frames that decode within the bound (test_torch_stream_generic.py holds
    them against the reference)."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import container as ct

    x = _x()
    raw = _port_stream("ec", config=slice_cfg(dz, ids_codec="deflate"))
    frames = _frames(raw)
    assert len(frames) == 3 and not any(ct.parse_v2(f)[0].dpk for f in frames)
    assert np.abs(dz.decompress(raw, device="cpu") - x).max() <= bound(x)
