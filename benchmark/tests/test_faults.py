"""A whole run, its look for a card skipped (the CPU rehearsal), with the
timed path broken underneath: `correct` comes out false for each fault a
cell of this benchmark can have. An answer altered where it is produced
(a decoded sample; a stored DC coefficient inside the encode; a decoded
sample of one field alone, the last of each cycle), and half of the array
left out of the compress. (No cell trains, and no cell of one chip
exchanges anything between chips.)"""

import json

import pytest

from benchmark import run


def _alter_decoded(monkeypatch):
    from dctz_tpu_torch import api

    real = api.decompress

    def decompress(blob, **kw):
        out = real(blob, **kw).copy()
        out[out.size // 3] += 0.01 * float(out.max() - out.min())
        return out

    monkeypatch.setattr(api, "decompress", decompress)


def _alter_one_field(monkeypatch, n_fields):
    """Only the last field's decodes: the set-up's warm round trip is call
    0, the window's round trip i (field i % n_fields) call i + 1."""
    from dctz_tpu_torch import api

    real = api.decompress
    calls = [0]

    def decompress(blob, **kw):
        out = real(blob, **kw)
        k = calls[0]
        calls[0] += 1
        if k >= 1 and (k - 1) % n_fields == n_fields - 1:
            out = out.copy()
            out[out.size // 3] += 0.01 * float(out.max() - out.min())
        return out

    monkeypatch.setattr(api, "decompress", decompress)


def _alter_stored(monkeypatch):
    from dctz_tpu_torch.ops import dpk_fuse

    real = dpk_fuse.encode_x_fused

    def encode_x_fused(*a, **kw):
        outs = list(real(*a, **kw))
        dc = outs[6].clone()
        dc[dc.shape[0] // 2] += 1.0  # scaled units: 1000 bin half-widths
        outs[6] = dc
        return tuple(outs)

    monkeypatch.setattr(dpk_fuse, "encode_x_fused", encode_x_fused)


def _half_left_out(monkeypatch):
    from dctz_tpu_torch import api

    real = api.compress

    def compress(x, **kw):
        return real(x[: x.shape[0] // 2], **kw)

    monkeypatch.setattr(api, "compress", compress)


FAULTS = {"decoded_sample": _alter_decoded, "stored_coefficient": _alter_stored,
          "half_left_out": _half_left_out}
N_FIELDS = {"nyx-ec.insitu": 6, "cesm-qt.posthoc": 5}


def _run(capsys, cell):
    assert run.main(["--workload", cell, "--seed", "5", "--seconds", "0.5",
                     "--trace", "0", "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["nyx-ec.insitu", "cesm-qt.posthoc"])
def test_sound_run_is_correct(capsys, cell):
    assert _run(capsys, cell)["correct"] is True


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["one_field_decoded"])
@pytest.mark.parametrize("cell", ["nyx-ec.insitu", "cesm-qt.posthoc"])
def test_fault_makes_the_run_incorrect(monkeypatch, capsys, cell, fault):
    if fault == "one_field_decoded":
        _alter_one_field(monkeypatch, N_FIELDS[cell])
    else:
        FAULTS[fault](monkeypatch)
    out = _run(capsys, cell)
    assert out["correct"] is False, out["checks"]
