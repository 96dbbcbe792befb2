"""CodecConfig.dc_delta on compress (the order-preserving u32 delta of the
DC stream, container.Header.dcd) against dctz_tpu.

The device delta (api._f32_delta_dev) equals entropy.f32_delta and
dctz_tpu.api._f32_delta_dev bit for bit on lengths on and off DC_RESTART,
with negatives, -0.0 and subnormals, and its inverse is the identity; the
byte-plane split applies it to the DC stream alone. On every route (DPK
monolithic and DTZS, host-coded v2 monolithic and DTZS, the v1
configuration's host-coded DTZS frames) the containers carry the dcd flag as
the reference's do, decode both ways within the bound, and decode bit-equal
to the same configuration without the delta (the delta is lossless); v1
keeps raw DC; the DPK container's flags are those of the committed golden
golden_v2_ec_f32_dpk_dcd.z.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from test_torch_oracle import (  # noqa: F401
    EB, EPS32, TILE_N, bound, oracle, oracle_shuffle,
)
from test_torch_qt import qt_signal
from test_torch_stream import _frames

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"
N = 5 * TILE_N - 11
SEG = 2 * TILE_N
#: lengths on and off the delta's restart period (entropy.DC_RESTART = 256)
LENGTHS = [1, 255, 256, 257, 3 * 256, 1000]
#: the routes of dc_delta=True, each writing containers with the dcd flag
ROUTES = {
    "dpk": dict(container="v2", ids_codec="device", segment_elems=0),
    "dpk_dtzs": dict(container="v2", ids_codec="device", segment_elems=SEG),
    "deflate": dict(container="v2", ids_codec="deflate", segment_elems=0),
    "deflate_dtzs": dict(container="v2", ids_codec="deflate", segment_elems=SEG),
    "v1_dtzs": dict(container="v1", segment_elems=SEG),
}
FLAGS = ("dpk", "dcd", "plc", "shuffle", "ids4", "rans")


def _dc_values(n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    a = (rng.standard_normal(n) * 1e3).astype(np.float32)
    a[::7] = -0.0
    a[::11] = np.float32(1e-40)  # subnormal
    a[::13] = -np.float32(3e-42)
    a[::17] = 0.0
    return a


@pytest.mark.parametrize("n", LENGTHS)
def test_f32_delta_dev_matches_host_and_reference(n):
    import jax.numpy as jnp
    from dctz_tpu import api as japi
    from dctz_tpu.core import entropy as jentropy
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import entropy

    a = _dc_values(n)
    got = api._f32_delta_dev(torch.from_numpy(a)).numpy()
    assert got.tobytes() == entropy.f32_delta(a).tobytes()
    assert got.tobytes() == jentropy.f32_delta(a).tobytes()
    assert got.tobytes() == np.asarray(japi._f32_delta_dev(jnp.asarray(a))).tobytes()
    back = api._f32_delta_inv_dev(torch.from_numpy(got)).numpy()
    assert back.tobytes() == a.tobytes()


@pytest.mark.parametrize("dcd", [False, True])
def test_plane_split_deltas_the_dc_stream_alone(dcd):
    """api._plane_split2's planes equal dctz_tpu's, byte for byte: the DC
    stream delta-coded when asked, the AC stream never."""
    import jax.numpy as jnp
    from dctz_tpu import api as japi
    from dctz_tpu_torch import api

    dc, ac = _dc_values(1000), _dc_values(3 * 512).reshape(3, 512)
    got = api._plane_split2(torch.from_numpy(dc), torch.from_numpy(ac), dcd)
    want = japi._plane_split2(jnp.asarray(dc), jnp.asarray(ac), dcd)
    for g, w in zip(got, want, strict=True):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def _containers(blob):
    """The v2 containers of a DTZS stream, or the container itself."""
    return _frames(blob) if blob[:4] == b"DTZS" else [blob]


def _header(frame):
    from dctz_tpu_torch.core import container as ct

    return ct.parse_v2(frame)[0]


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_dc_delta_containers_match_reference(oracle_shuffle, route, mode):
    """Each package decodes the other's container within the bound, the
    port's decode of the reference's within 32 eps32 * sf of the
    reference's own, and every frame carries the dcd flag and the other
    flags as the reference's does."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    x = qt_signal(N, 7)
    kw = dict(mode=mode, error_bound=EB, verify=True, dc_delta=True, **ROUTES[route])
    port = dz.compress(x, config=dz.CodecConfig(**kw), device="cpu")
    ref = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(**kw))
    assert (port[:4] == b"DTZS") == (ref[:4] == b"DTZS") == route.endswith("dtzs")
    assert np.abs(np.asarray(dctz_tpu.decompress(port)) - x).max() <= bound(x)
    got = dz.decompress(ref, device="cpu")
    assert np.abs(got - x).max() <= bound(x)
    sf = _header(_containers(ref)[0]).scaling_factor
    assert np.abs(got - np.asarray(dctz_tpu.decompress(ref))).max() <= 32 * EPS32 * sf
    for fp, fr in zip(_containers(port), _containers(ref), strict=True):
        hp, hr = _header(fp), _header(fr)
        assert hp.dcd
        assert {f: getattr(hp, f) for f in FLAGS} == {f: getattr(hr, f) for f in FLAGS}


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_dc_delta_is_lossless(route, mode):
    """The same configuration with and without the delta: the decodes are
    bit-equal, and so is every section but DC (and the stored qtable, whose
    slot 0 keeps the un-delta'd DC)."""
    import dctz_tpu_torch as dz

    x = qt_signal(N, 8)
    kw = dict(mode=mode, error_bound=EB, verify=True, **ROUTES[route])
    plain = dz.compress(x, config=dz.CodecConfig(**kw), device="cpu")
    delta = dz.compress(x, config=dz.CodecConfig(dc_delta=True, **kw), device="cpu")
    assert plain != delta
    y = dz.decompress(delta, device="cpu")
    assert y.tobytes() == dz.decompress(plain, device="cpu").tobytes()
    from dctz_tpu_torch.core import container as ct

    for fp, fd in zip(_containers(plain), _containers(delta), strict=True):
        (hp, sp, qp, _c), (hd, sd, qd, _c2) = ct.parse_v2(fp), ct.parse_v2(fd)
        assert (hp.dcd, hd.dcd) == (False, True)
        dc_i = len(sp) - 2
        assert [b"".join(c) for i, c in enumerate(sp) if i != dc_i] == [
            b"".join(c) for i, c in enumerate(sd) if i != dc_i]
        assert (qp is None) == (qd is None) and (qp is None or qp.tobytes() == qd.tobytes())


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_v1_keeps_raw_dc(mode):
    """A monolithic v1 container has no dcd flag: dc_delta leaves it as it
    is (api._dcd_on), as dctz_tpu does."""
    import dctz_tpu_torch as dz

    x = qt_signal(N, 9)
    kw = dict(mode=mode, error_bound=EB, verify=True, segment_elems=0)
    assert dz.compress(x, config=dz.CodecConfig(dc_delta=True, **kw), device="cpu") == (
        dz.compress(x, config=dz.CodecConfig(**kw), device="cpu"))


def test_dpk_flags_match_the_dcd_golden():
    """The committed DPK dcd golden's configuration (tests/test_golden.py)
    on its input: the port's container has the golden's flags and section
    count, and decodes within the bound."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import container as ct

    name = "golden_v2_ec_f32_dpk_dcd"
    golden = ct.parse_v2((GOLDEN / f"{name}.z").read_bytes())
    x = np.fromfile(GOLDEN / "golden_input_f64.bin", np.float64).astype(np.float32)
    assert x.size == json.loads((GOLDEN / "manifest.json").read_text())[name]["n"]
    cfg = dz.CodecConfig(mode="ec", error_bound=1e-3, container="v2", chunk_bytes=2048,
                         ids_codec="device", dc_delta=True)
    blob = dz.compress(x, config=cfg, device="cpu")
    header, streams, _q, _cb = ct.parse_v2(blob)
    flags = ("dpk", "dcd", "plc", "shuffle", "ids4", "rans", "dpks", "dpkz", "dpkr")
    assert {f: getattr(header, f) for f in flags} == {f: getattr(golden[0], f) for f in flags}
    assert len(streams) == len(golden[1])
    assert np.abs(dz.decompress(blob, device="cpu") - x).max() <= bound(x)
