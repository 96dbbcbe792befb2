"""The fused soak of tests/test_soak.py's
test_random_config_roundtrips_fused through the port (device="cpu"), draw
for draw (torch_common.fused_configs): the device id coder, verify and
segmented streams on float32, under the module-scoped oracle of
tests/test_torch_oracle.py (x64 off). The port's containers are the
reference's byte for byte (assert_byte_equal: the DPK frames of the fused
route allowed their bin-edge flips, the mean within MEAN_ULPS), with the
QT renormalization's and the transforms' rounding set to the reference's
XLA CPU arithmetic (ref_arithmetic), and the port's decode holds the
reference's bounds.
"""

import pytest
import torch

import dctz_tpu_torch as dz
from test_torch_oracle import (  # noqa: F401
    assert_byte_equal, oracle, ref_arithmetic,
)
from torch_common import fused_configs, soak_rel_ok

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", range(2))
def test_random_config_roundtrips_fused(oracle, ref_arithmetic, seed):
    """The fused soak's knobs (the device id coder, verify, segmented
    streams) on float32: the port's container is the reference's under
    the oracle, and the port's decode holds the reference's bounds."""
    import dctz_tpu

    for x, kw in fused_configs(seed):
        port = dz.compress(x, config=dz.CodecConfig(**kw), device="cpu")
        ref = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(**kw))
        assert_byte_equal(port, ref, x, edge_flips=True)
        y = dz.decompress(port, device="cpu")
        assert y.shape == x.shape and y.dtype == x.dtype
        assert soak_rel_ok(x, y, kw, fused=True), kw
