"""The randomized configuration-space soak of tests/test_soak.py's
test_random_config_roundtrips through the port (device="cpu"), draw for
draw (torch_common.roundtrip_configs), and across the two packages: the
port's round trip within the reference's bound, the reference decoding
each port container within it, and the port decoding each reference
container within rtol 1e-5, atol 1e-7 * max(1, max|x|) of the reference's
own decode (the reference writes host-coded ids where its CPU rule takes
them for "auto", the port DPK, so both coders cross); the C codec decodes
the port's v1 containers as the reference (x64 on) does, within the
reference's tolerance. The reference runs float64 draws with x64 on, as
tests/conftest.py leaves it, and float32 draws with x64 off, the
configuration the port's float32 arithmetic is held to (with x64 on it
decodes float32 QT containers in other float operations: ROADMAP §3). The
fused soak is tests/test_torch_soak_fused.py.
"""

import jax
import numpy as np
import pytest
import torch

import dctz_tpu_torch as dz
from torch_common import roundtrip_configs, soak_rel_ok

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", range(4))
def test_random_config_roundtrips(seed):
    for x, kw in roundtrip_configs(seed):
        with jax.enable_x64(x.dtype == np.float64):
            _roundtrip(x, kw)


def _roundtrip(x: np.ndarray, kw: dict) -> None:
    import dctz_tpu

    from dctz_tpu_torch import native

    blob = dz.compress(x, config=dz.CodecConfig(**kw), device="cpu")
    y = dz.decompress(blob, device="cpu")
    assert y.shape == x.shape and y.dtype == x.dtype
    assert soak_rel_ok(x, y, kw), kw
    y_ref = np.asarray(dctz_tpu.decompress(blob))
    assert y_ref.shape == x.shape and y_ref.dtype == x.dtype
    assert soak_rel_ok(x, y_ref, kw), kw
    if kw["container"] == "v1" and native.available():
        # the reference's own check, in its configuration (x64 on)
        with jax.enable_x64(True):
            y_ref64 = np.asarray(dctz_tpu.decompress(blob))
        np.testing.assert_allclose(
            y_ref64, native.decompress(blob), rtol=1e-5,
            atol=1e-7 * max(1.0, float(np.abs(x).max())))
    ref = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(**kw))
    want = np.asarray(dctz_tpu.decompress(ref))
    got = dz.decompress(ref, device="cpu")
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-7 * max(1.0, float(np.abs(x).max())))
