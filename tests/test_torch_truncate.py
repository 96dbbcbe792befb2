"""truncate=False (full-width stored values) in the port against dctz_tpu.

Float64 data keeps its DC and escaped AC values at 8 bytes an item, as the
C codec's non-USE_TRUNCATE build does (tests/test_roundtrip.py:121-142):
held to dctz_tpu as tests/conftest.py leaves it (x64 on, no fused force,
its float64 configuration; tests/test_torch_f64.py) in v1, host-coded v2,
DPK v2 (the XLA chain's route) and DTZS, EC and QT. Float32 data stores
float32 either way but leaves the fused kernels for the generic chain, as
the reference does: held to the oracle of test_torch_oracle.py; those
tests come last, as the module-scoped oracle leaves x64 off.

Containers are held byte for byte but for the mean with two float
operations of the port set to the reference's XLA CPU arithmetic
(ref_arithmetic: the transforms' products, which add in other orders, and
the QT renormalization's rounding; 8-byte items show both); the port's own
containers decode both ways within the bound. No float64 value passes
through kernels H or I (kernel_calls).
"""

import numpy as np
import pytest
import torch

from test_torch_f64 import EPS64, signal64
from test_torch_oracle import (  # noqa: F401
    assert_byte_equal, frames_of, kernel_calls, oracle, parse_any,
    ref_arithmetic, signal,
)

torch.set_num_threads(2)

EB = 1e-3
N = 20000 + 1
SEG = 8192
FAMILIES = {
    "v1": dict(container="v1"),
    "host_coded": dict(container="v2", ids_codec="deflate", segment_elems=0),
    "dpk": dict(container="v2", ids_codec="device", segment_elems=0),
    "dtzs": dict(container="v2", ids_codec="device", segment_elems=SEG),
}


def _bound(x):
    return EB * float(x.max() - x.min())


def _stored_items(blob) -> list:
    """The itemsize of each frame's stored DC values, as the port's decoder
    reads it from the DC section's size (api._host_stage)."""
    from dctz_tpu_torch import api

    out = []
    for f in frames_of(blob):
        host_arrays = api._host_stage(f)[2]
        # a DPK frame's float32 DC byte planes ride in its one upload
        # buffer (the device reassembles them); other stored DC values
        # follow it, as the host-coded frames' follow their ids
        dc = host_arrays[1] if len(host_arrays) > 1 else None
        out.append(4 if dc is None else dc.dtype.itemsize)
    return out


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_f64_full_width_matches_reference(ref_arithmetic, kernel_calls,
                                          family, mode):
    import dctz_tpu
    import dctz_tpu_torch as dz

    x = signal64(N, 21)
    kw = dict(FAMILIES[family], mode=mode, error_bound=EB, verify=True,
              truncate=False)
    port = dz.compress(x, config=dz.CodecConfig(**kw), device="cpu")
    ref = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(**kw))
    assert_byte_equal(port, ref, x)
    frames = frames_of(port)
    assert len(frames) == (3 if family == "dtzs" else 1)
    assert _stored_items(port) == [8] * len(frames)
    for f in frames:
        h = parse_any(f)[0]
        # a v1 header has no truncate field: its decoder reads the width
        # from the DC section's size
        assert h.dtype == np.float64 and h.truncate == (family == "v1")
        assert h.dpk == (family == "dpk")
    assert "H64" not in kernel_calls and "I64" not in kernel_calls
    got = dz.decompress(ref, device="cpu")
    want = np.asarray(dctz_tpu.decompress(ref))
    assert got.dtype == np.float64 and np.abs(got - want).max() <= (
        8 * EPS64 * np.abs(want).max())
    for y in (got, dz.decompress(port, device="cpu"),
              np.asarray(dctz_tpu.decompress(port))):
        assert y.dtype == np.float64 and np.abs(y - x).max() <= _bound(x)
    assert "H64" not in kernel_calls and "I64" not in kernel_calls


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("family", ["v1", "dpk"])
def test_f64_full_width_own_transforms(family, mode):
    """The port's own container (its own transforms) beside the reference's:
    the same header but for the mean and the counts, a size within 0.5%,
    and the stored values of the same escapes within 64 eps64 of the
    block's largest |x / sf| (the transforms' ulp budget,
    tests/test_torch_f64.py); each package decodes the other's within the
    bound."""
    import dataclasses

    import dctz_tpu
    import dctz_tpu_torch as dz

    x = signal64(N, 22)
    kw = dict(FAMILIES[family], mode=mode, error_bound=EB, verify=True,
              truncate=False)
    port = dz.compress(x, config=dz.CodecConfig(**kw), device="cpu")
    ref = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(**kw))
    hp, hr = parse_any(port)[0], parse_any(ref)[0]
    keep = dict(mean=0.0, ac_count=0, bindex_nbytes=0, dc_nbytes=0, ac_nbytes=0)
    assert dataclasses.replace(hp, **keep) == dataclasses.replace(hr, **keep)
    assert abs(len(port) / len(ref) - 1.0) <= 0.005
    from dctz_tpu_torch import api

    dc_p, dc_r = (api._host_stage(b)[2][1] for b in (port, ref))
    scale = np.abs(x / hp.scaling_factor).max()
    assert dc_p.dtype == np.float64
    assert np.abs(dc_p - dc_r).max() <= 64 * EPS64 * scale * 8
    for blob in (port, ref):
        for y in (dz.decompress(blob, device="cpu"),
                  np.asarray(dctz_tpu.decompress(blob))):
            assert np.abs(y - x).max() <= _bound(x)


# ---------------------------------------------------------------------------
# float32 truncate=False: the generic chain under the oracle (x64 off from
# here to the end of the module)
# ---------------------------------------------------------------------------

F32_FAMILIES = dict(FAMILIES, v1_fused_length=dict(container="v1"))


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("family", list(F32_FAMILIES))
def test_f32_truncate_off_matches_reference(oracle, ref_arithmetic,
                                            kernel_calls, family, mode):
    """Float32 with truncate=False writes what the reference writes: the
    generic chain (never kernels A-G, even at a length the fused v1 branch
    would take), float32 stored values, truncate=False in a v2 header."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    n = 4 * 4096 if family == "v1_fused_length" else N
    x = signal(n, 23)
    kw = dict(F32_FAMILIES[family], mode=mode, error_bound=EB, verify=True,
              truncate=False)
    port = dz.compress(x, config=dz.CodecConfig(**kw), device="cpu")
    ref = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(**kw))
    assert_byte_equal(port, ref, x)
    assert not any(k in kernel_calls for k in ("A", "B", "E", "FG"))
    assert _stored_items(port) == [4] * len(frames_of(port))
    for y in (dz.decompress(port, device="cpu"),
              np.asarray(dctz_tpu.decompress(port)),
              dz.decompress(ref, device="cpu")):
        assert y.dtype == np.float32 and np.abs(y - x).max() <= _bound(x)
