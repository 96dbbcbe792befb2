"""The plain reference decodes the port's containers (EC and QT,
monolithic and DTZS) as the port does, within the port's float32
rounding, and its rANS decoder reads the C++ codec's blobs."""

import numpy as np
import pytest

import dctz_tpu_torch as dz
from benchmark.data import grf
from benchmark.reference import check, codec, rans
from benchmark.reference import container as ct

FIELD = {"shape": [32, 32, 32], "fields": [
    {"name": "d", "kind": "lognormal", "scale": 1.0, "sigma": 1.0,
     "knee": 0.03125, "slope": 8.0}]}


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("segment", [0, 4096])
def test_reference_decodes_port_containers(mode, segment):
    x = grf.make_field(FIELD, 0, 5, "cpu").numpy()
    cfg = dz.CodecConfig(mode=mode, error_bound=1e-3, container="v2",
                         ids_codec="device", verify=True, segment_elems=segment)
    blob = dz.compress(x, config=cfg, device="cpu")
    out = dz.decompress(blob, device="cpu")
    if segment:
        total, frames = ct.frames(blob)
        assert total == x.size and len(frames) == x.size // segment
        ref = np.concatenate([codec.decode(f) for f in frames])
    else:
        ref = codec.decode(blob)
    unit = 1e-3 * float(x.max() - x.min())
    assert np.abs(out - ref).max() / unit < 0.01
    assert np.abs(x - ref).max() / unit <= 1.0
    config = {"codec": {"mode": mode, "error_bound": 1e-3},
              "container": ({"kind": "dtzs", "segment_elems": segment}
                            if segment else {"kind": "v2"})}
    r = check.check(x, blob, out, config, 3, 8)
    assert r["bad"] == 0 and r["bound"] <= 1.0 and r["coef_gap"] < 1.1


def test_flipped_byte_is_a_structural_fault():
    x = grf.make_field(FIELD, 0, 6, "cpu").numpy()
    cfg = dz.CodecConfig(error_bound=1e-3, container="v2", ids_codec="device",
                         verify=True, segment_elems=0)
    blob = bytearray(dz.compress(x, config=cfg, device="cpu"))
    blob[len(blob) // 2] ^= 0x10
    with pytest.raises(ValueError):
        ct.parse(bytes(blob))


@pytest.mark.parametrize("n", [1, 1000, (1 << 20) + 3])
def test_rans_reads_the_native_codec(n):
    native = pytest.importorskip("dctz_tpu_torch.native")
    if not native.available():
        pytest.skip("the C++ codec does not build here")
    rng = np.random.default_rng(n)
    data = np.clip(rng.geometric(0.2, n), 0, 255).astype(np.uint8).tobytes()
    assert rans.decompress(native.rans_compress(data)) == data
