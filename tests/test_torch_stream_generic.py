"""Host-coded DTZS frames (dctz_tpu_torch/stream.py's generic segment path:
_qtable_colmax_segment, _encode_segment, _pack_segment and the reader's
kernels I + D) against dctz_tpu/stream.py's, at n = 4 * 16384 + 1025 in
segments of 2 * 16384 (three frames, the last ending mid-block).

For mode {ec, qt} x ids codec {the v1 configuration's "auto", "deflate",
"rans"} x verify {off, on} (verify on takes an input where the repair
fires; verify off one that holds the bound without it): each package
decodes the other's stream within the bound, the two decodes of the
reference stream agree within 32 eps32 * sf, the ratio within 0.5%, and per
frame n, sf and the mean (the host route: the same float64 segment sums)
are exact, ac_count within AC_SLACK, the flags equal, the qtable within 4
ulp and its slot 0 the frame's last real block's DC. Also: the global QT
table equals the monolithic generic chain's, a row overflow retried in the
compaction alone gives the frame of a whole-segment rerun at full width,
the relaxed analysis within its budget, the device route's mean, and the
routing of the writer and the reader.
"""

import io

import numpy as np
import pytest
import torch

from test_torch_oracle import (  # noqa: F401
    EB, EPS32, TILE_N, assert_mean_close, bound, oracle, oracle_shuffle,
)
from test_torch_qt import qt_signal
from test_torch_stream import _frames
from test_torch_v1 import AC_SLACK

torch.set_num_threads(2)

N = 4 * TILE_N + 1025
SEG = 2 * TILE_N
#: the ids codec of a host-coded frame: a v1 configuration leaves
#: ids_codec "auto" (native rANS when the library is built, else deflate)
CODECS = {
    "v1": dict(container="v1"),
    "deflate": dict(container="v2", ids_codec="deflate"),
    "rans": dict(container="v2", ids_codec="rans"),
}
CASES = [(m, c, v) for m in ("ec", "qt") for c in CODECS for v in (False, True)]
CASE_IDS = [f"{m}-{c}-{'verify' if v else 'noverify'}" for m, c, v in CASES]
FLAGS = ("dpk", "ids4", "rans", "zst", "shuffle", "dcd", "plc")


def _x(verify: bool) -> np.ndarray:
    """verify on: noise in a narrow range, where the repair fires in many
    blocks; verify off: the x30 signal, which holds the bound without it
    and whose qtable has entries > 1."""
    return qt_signal(N, 21, narrow=verify)


def _cfg(pkg, mode, codec, verify, **kw):
    return pkg.CodecConfig(**dict(mode=mode, error_bound=EB, verify=verify,
                                  segment_elems=SEG, **CODECS[codec]) | kw)


def _write(stream_mod, x, cfg, **kw) -> bytes:
    buf = io.BytesIO()
    stream_mod.compress_stream(x, buf, config=cfg, segment_elems=SEG, **kw)
    return buf.getvalue()


def _need_native(codec):
    from dctz_tpu_torch import native

    if codec == "rans" and not native.available():
        pytest.skip("the native rANS coder is not built here")


@pytest.fixture(scope="module")
def streams(oracle_shuffle):
    """get(mode, codec, verify) -> (x, the port's stream, dctz_tpu's
    stream), each written once from the numpy input (both writers' host
    route)."""
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu import stream as jstream
    from dctz_tpu_torch import stream

    cache = {}

    def get(mode, codec, verify):
        _need_native(codec)
        key = (mode, codec, verify)
        if key not in cache:
            x = _x(verify)
            cache[key] = (
                x,
                _write(stream, x, _cfg(dz, mode, codec, verify), device="cpu"),
                _write(jstream, x, _cfg(dctz_tpu, mode, codec, verify)),
            )
        return cache[key]

    return get


def _parse(frame):
    from dctz_tpu_torch.core import container as ct

    header, streams, qtable, _cb = ct.parse_v2(frame)
    return header, streams, qtable


def _last_block_dc(frame) -> np.float32:
    """The DC of a host-coded frame's last real block, from its sections."""
    from dctz_tpu_torch import api

    header, streams, _q = _parse(frame)
    dc = np.frombuffer(api._inflate_v2_streams(header, streams)[1], np.float32)
    return dc[-(-header.num_elements // 64) - 1]


@pytest.mark.parametrize("mode,codec,verify", CASES, ids=CASE_IDS)
def test_port_stream_decodes_in_reference(streams, mode, codec, verify):
    import dctz_tpu

    x, port, ref = streams(mode, codec, verify)
    assert port[:4] == b"DTZS"
    y = np.asarray(dctz_tpu.decompress(port))
    assert y.shape == x.shape and np.abs(y - x).max() <= bound(x)
    assert abs(len(port) / len(ref) - 1.0) <= 0.005, (len(port), len(ref))


@pytest.mark.parametrize("mode,codec,verify", CASES, ids=CASE_IDS)
def test_reference_stream_decodes_in_port(streams, mode, codec, verify):
    import dctz_tpu
    import dctz_tpu_torch as dz

    x, _port, ref = streams(mode, codec, verify)
    got = dz.decompress(ref, device="cpu")
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.abs(got - x).max() <= bound(x)
    sf = _parse(_frames(ref)[0])[0].scaling_factor
    assert np.abs(got - np.asarray(dctz_tpu.decompress(ref))).max() <= 32 * EPS32 * sf


@pytest.mark.parametrize("mode,codec,verify", CASES, ids=CASE_IDS)
def test_frame_headers_match_reference(streams, mode, codec, verify):
    """Per frame: n, sf and the mean exact, ac_count within AC_SLACK, the
    flags equal (host-coded v2 frames, whatever the config's container;
    rANS for the v1 configuration where the native library is built), the
    qtable within 4 ulp of the reference's and its slot 0 the frame's own
    last real block's DC."""
    from dctz_tpu_torch import native

    x, port, ref = streams(mode, codec, verify)
    got, want = _frames(port), _frames(ref)
    assert len(got) == len(want) == 3
    for g, r in zip(got, want):
        (hg, _s, qg), (hr, _s2, qr) = _parse(g), _parse(r)
        assert (hg.num_elements, hg.scaling_factor, hg.mode, hg.mean) == (
            hr.num_elements, hr.scaling_factor, hr.mode, hr.mean)
        assert abs(hg.ac_count - hr.ac_count) <= AC_SLACK
        assert {f: getattr(hg, f) for f in FLAGS} == {f: getattr(hr, f) for f in FLAGS}
        assert not hg.dpk and hg.ids4 and not hg.dcd and not hg.plc
        assert hg.rans == (codec == "rans" or (codec == "v1" and native.available()))
        assert (qg is None) == (qr is None) == (mode == "ec")
        if qg is not None:
            ulps = np.abs(qg[1:] - qr[1:]) / np.spacing(np.abs(qr[1:]))
            assert ulps.max() <= 4
            assert qg[0] == _last_block_dc(g) and qr[0] == _last_block_dc(r)
    assert _parse(got[-1])[0].num_elements == 1025
    if mode == "qt" and not verify:
        assert (_parse(got[0])[2][1:] > 1.0).any()


@pytest.mark.parametrize("verify", [False, True])
def test_global_qtable_equals_monolithic(verify):
    """Every frame's qtable slots >= 1 are the monolithic generic chain's
    (the v1 container at n % 1024 != 0) bit for bit: the writer max-reduces
    the segments' column maxima, and max is associative."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import stream
    from dctz_tpu_torch.core import container as ct

    x = _x(verify)
    mono = dz.compress(x, config=dz.CodecConfig(mode="qt", error_bound=EB, verify=verify),
                       device="cpu")
    q_mono = ct.parse_v1(mono)[4]
    for frame in _frames(_write(stream, x, _cfg(dz, "qt", "deflate", verify),
                                device="cpu")):
        assert _parse(frame)[2][1:].tobytes() == q_mono[1:].tobytes()


def _overflow_input():
    """White noise at eb 1e-4: chunk rows hold more AC escapes than the
    default capacity."""
    return np.random.default_rng(3).standard_normal(N).astype(np.float32)


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_overflow_retry_equals_whole_segment_rerun(oracle_shuffle, mode, monkeypatch):
    """A segment whose chunk rows overflow the default capacity: the port
    retries the compaction alone at full chunk width, dctz_tpu reruns the
    whole segment there. The port's stream is byte-equal to the one it
    writes with every segment compacted at full width from the start, and
    it agrees with the reference's as the other cases do."""
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu import stream as jstream
    from dctz_tpu_torch import api, stream
    from dctz_tpu_torch.ops import compaction as cp

    x = _overflow_input()
    cfg = _cfg(dz, mode, "deflate", True, error_bound=1e-4)
    port = _write(stream, x, cfg, device="cpu")
    ref = _write(jstream, x, _cfg(dctz_tpu, mode, "deflate", True, error_bound=1e-4))
    widths = []
    for frame in _frames(port):
        header, streams, _q = _parse(frame)
        (_ids, _dc, rows), _n, _c = api._host_coded_prep(
            header, *api._inflate_v2_streams(header, streams))
        widths.append(rows.shape[1])
    assert max(widths) > cp.CAPC
    monkeypatch.setattr(cp, "CAPC", cp.CHUNK_W)
    assert _write(stream, x, cfg, device="cpu") == port
    bnd = 1e-4 * float(x.max() - x.min())
    assert np.abs(np.asarray(dctz_tpu.decompress(port)) - x).max() <= bnd
    assert np.abs(dz.decompress(ref, device="cpu") - x).max() <= bnd
    for g, r in zip(_frames(port), _frames(ref), strict=True):
        hg, hr = _parse(g)[0], _parse(r)[0]
        assert (hg.num_elements, hg.scaling_factor, hg.mean) == (
            hr.num_elements, hr.scaling_factor, hr.mean)
        assert abs(hg.ac_count - hr.ac_count) <= AC_SLACK


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_relaxed_frames_match_reference(oracle_shuffle, mode):
    """dct_precision="high" on host-coded frames (transform.dot_bf16x3 in
    the generic chain), under tests/test_torch_precision.py's budget: each
    package decodes the other's stream within the bound, the two decodes
    of the reference stream within 32 eps32 * sf, the headers' n, sf and
    mean equal (no ratio check: dctz_tpu's XLA transform on the CPU ignores
    the precision)."""
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu import stream as jstream
    from dctz_tpu_torch import stream

    x = _x(True)
    kw = dict(dct_precision="high")
    port = _write(stream, x, _cfg(dz, mode, "deflate", True, **kw), device="cpu")
    ref = _write(jstream, x, _cfg(dctz_tpu, mode, "deflate", True, **kw))
    assert np.abs(np.asarray(dctz_tpu.decompress(port)) - x).max() <= bound(x)
    got = dz.decompress(ref, device="cpu")
    assert np.abs(got - x).max() <= bound(x)
    for g, r in zip(_frames(port), _frames(ref), strict=True):
        hg, hr = _parse(g)[0], _parse(r)[0]
        assert (hg.num_elements, hg.scaling_factor, hg.mean) == (
            hr.num_elements, hr.scaling_factor, hr.mean)
    assert np.abs(got - np.asarray(dctz_tpu.decompress(ref))).max() <= (
        32 * EPS32 * hr.scaling_factor)


def test_relaxed_frames_take_the_relaxed_transform(monkeypatch):
    """The generic segments' forward transforms (the QT pass 1 and the
    encode) follow dct_precision; the repair's reconstruction is the
    inverse alone."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import stream
    from dctz_tpu_torch.core import transform

    seen = []
    forward = transform.forward

    def spy(xs, bs, precision="highest"):
        seen.append(precision)
        return forward(xs, bs, precision)

    monkeypatch.setattr(transform, "forward", spy)
    for prec in ("high", "highest"):
        seen.clear()
        _write(stream, _x(True), _cfg(dz, "qt", "deflate", True, dct_precision=prec),
               device="cpu")
        assert seen == [prec] * 6  # three segments, two passes each


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_device_route_mean(oracle_shuffle, mode):
    """A tensor input (and compress(), which hands the writer one) takes
    the device route: the mean of a float32 sum, within the ulp budget of
    dctz_tpu's from a JAX array; the sections equal the host route's."""
    import dctz_tpu
    import dctz_tpu_torch as dz
    import jax.numpy as jnp
    from dctz_tpu import stream as jstream
    from dctz_tpu_torch import stream

    x = _x(False)
    cfg = _cfg(dz, mode, "deflate", False)
    dev = _write(stream, torch.from_numpy(x), cfg, device="cpu")
    host = _write(stream, x, cfg, device="cpu")
    ref = _write(jstream, jnp.asarray(x), _cfg(dctz_tpu, mode, "deflate", False))
    assert dz.compress(x, config=cfg, device="cpu") == dev
    for d, h, r in zip(_frames(dev), _frames(host), _frames(ref), strict=True):
        (hd, sd, qd), (hh, sh, qh) = _parse(d), _parse(h)
        assert [b"".join(c) for c in sd] == [b"".join(c) for c in sh]
        assert_mean_close(hd, _parse(r)[0], x)


@pytest.mark.parametrize("codec", list(CODECS))
def test_writer_and_reader_route_generic_frames(codec, monkeypatch):
    """A configuration without the device ids takes the generic segment
    path (no DPK kernel wrapper is called) and writes host-coded frames,
    which the reader decodes through kernel I (qz.expand_ac) and kernel D
    (dpk_fuse.dequant_idct), not C + D; compress() with an int
    segment_elems writes the same stream from a tensor."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import stream
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.ops import dpk_fuse

    _need_native(codec)
    calls = []
    for mod, name in ((dpk_fuse, "encode_x_fused"), (dpk_fuse, "decode_fused"),
                      (dpk_fuse, "dequant_idct"), (qz, "expand_ac"), (qz, "repack")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    x = _x(False)
    cfg = _cfg(dz, "ec", codec, False)
    raw = _write(stream, x, cfg, device="cpu")
    assert calls == ["repack"] * 3
    calls.clear()
    y = dz.decompress(raw, device="cpu")
    assert calls == ["expand_ac", "dequant_idct"] * 3
    assert np.abs(y - x).max() <= bound(x)
    assert all(not _parse(f)[0].dpk for f in _frames(raw))
    blob = dz.compress(x, config=cfg, device="cpu")
    assert blob[:4] == b"DTZS" and dz.decompress(blob, device="cpu").tobytes() == y.tobytes()


def test_generic_trace_covers_every_segment():
    from dctz_tpu_torch import stream

    import dctz_tpu_torch as dz

    from dctz_tpu_torch.utils.timing import StageTimer

    enc, dec = StageTimer(), StageTimer()
    raw = _write(stream, _x(True), _cfg(dz, "qt", "deflate", True), device="cpu",
                 timer=enc)
    list(stream.decompress_stream(io.BytesIO(raw), timer=dec, device="cpu"))
    for timer, kinds in ((enc, ("pipeline.encode", "pack.pull", "pack.host")),
                         (dec, ("prep", "pipeline.decode", "copy_out"))):
        for kind in kinds:
            spans = [s for s in timer.spans if s.name == kind]
            assert [s.index for s in spans] == [0, 1, 2]
            assert all(s.t1 >= s.t0 for s in spans)
        assert timer.counts["frames"] == 3
