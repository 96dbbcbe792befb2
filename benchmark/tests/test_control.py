"""The control (the reference codec in bfloat16 in the program's place)
fails the check at every configuration, where the program passes it; at
the configurations' rehearsal size, on three seeds."""

import json
import pathlib

import pytest

import dctz_tpu_torch as dz
from benchmark.data import grf
from benchmark.reference import check, control

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _rehearsal_config(name):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    reh = cfg["rehearsal"]
    codec = dict(cfg["codec"])
    if "segment_elems" in reh:
        codec["segment_elems"] = reh["segment_elems"]
        cfg["container"] = dict(cfg["container"], segment_elems=reh["segment_elems"])
    cfg["codec"] = codec
    return cfg, reh["shape"]


@pytest.mark.parametrize("seed", [1, 2, 2**33 + 5])
@pytest.mark.parametrize("name", ["nyx-512-ec", "cesm-atm-qt"])
def test_control_fails_where_the_program_passes(name, seed):
    cfg, shape = _rehearsal_config(name)
    limits = cfg["check"]["limits"]
    frames = int(cfg["check"]["frames"])
    for i in range(len(cfg["fields"])):
        x = grf.make_field(cfg, i, seed, "cpu", shape).numpy()
        blob = dz.compress(x, config=dz.CodecConfig(**cfg["codec"]), device="cpu")
        out = dz.decompress(blob, device="cpu")
        prog = check.check(x, blob, out, cfg, seed, frames)
        ctl = control.readings(x, cfg, seed, frames, "cpu")
        assert all(prog[k] <= limits[k] for k in limits), (i, prog)
        assert any(ctl[k] > limits[k] for k in limits), (i, ctl)
