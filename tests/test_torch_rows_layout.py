"""Kernel N's plain twin (ops/dpk_fuse.dpk_rows_layout on the CPU) against
the host re-pad it replaced (entropy.pad_row_prefixes), and the whole-
container DPK decode that uploads tight streams against a decode fed by
host-padded rows. Free of jax: the card's copy of the first test is
tests/test_torch_cuda.py::test_kernel_n_equals_twin."""

import json
import pathlib

import numpy as np
import pytest
import torch

from torch_common import host_padded_arrays

CAPS = (32, 64, 128, 256, 512)
ITEMS = (1, 4, 8, "planes")
ROWS = 37
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _lens(kind: str, cap: int, rng) -> np.ndarray:
    if kind == "zero":
        return np.zeros(ROWS, np.int64)
    if kind == "full":
        return np.full(ROWS, cap, np.int64)
    lens = rng.integers(0, cap + 1, ROWS)
    lens[:3] = (0, cap, 1)
    return lens.astype(np.int64)


def _offsets(lens: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(([0], np.cumsum(lens))).astype(np.int64))


@pytest.mark.parametrize("item", ITEMS)
@pytest.mark.parametrize("lens_kind", ["zero", "full", "mixed"])
@pytest.mark.parametrize("cap", CAPS)
def test_twin_equals_host_pad(cap, lens_kind, item):
    """Every section of the twin, byte for byte the host's pad of the same
    tight stream: bytes (the packed and exception slots, and the AC slot's
    byte rows), raw items of 4 and 8 bytes (the AC slot's byte rows of a
    stored dtype), and four byte planes combined into float32 rows, against
    the host's pad of the planes followed by api._combine_planes."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import entropy
    from dctz_tpu_torch.ops import dpk_fuse as fk

    rng = np.random.default_rng(cap * 31 + len(lens_kind) * 7 + len(str(item)))
    lens = _lens(lens_kind, cap, rng)
    n = int(lens.sum())
    off = _offsets(lens)
    ids = rng.integers(0, 256, n, dtype=np.uint8)
    want_ids = entropy.pad_row_prefixes(ids, lens, cap, np.uint8)
    t_ids = torch.from_numpy(ids)
    if item == "planes":
        vals = rng.integers(0, 2**32, n, dtype=np.uint32).view(np.float32)
        planes = np.stack([(vals.view(np.uint32) >> (8 * k)).astype(np.uint8)
                           for k in range(4)])
        padded = entropy.pad_row_prefixes(planes.reshape(-1), np.tile(lens, 4),
                                          cap, np.uint8).reshape(4, ROWS, cap)
        want_ac = api._combine_planes(torch.from_numpy(padded)).numpy()
        assert np.array_equal(
            want_ac.view(np.uint32),
            entropy.pad_row_prefixes(vals, lens, cap, np.float32).view(np.uint32))
        ac, ac_off, capc = torch.from_numpy(planes), off, cap
    else:
        isz = item
        vals = rng.integers(0, 256, n * isz, dtype=np.uint8).view(f"<u{isz}")
        want_ac = entropy.pad_row_prefixes(vals, lens, cap, vals.dtype).view(np.uint8)
        ac, ac_off, capc = torch.from_numpy(vals.view(np.uint8)), off * isz, cap * isz
    got_p, got_e, got_a = fk.dpk_rows_layout(t_ids, off, cap, t_ids, off, cap, ac,
                                             ac_off, capc)
    assert fk.LAUNCHES["dpk_rows_layout"] == 0  # the twin launches nothing
    assert np.array_equal(got_p.numpy(), want_ids)
    assert np.array_equal(got_e.numpy(), want_ids)
    got_a = got_a.numpy()
    assert got_a.dtype == (np.float32 if item == "planes" else np.uint8)
    assert np.array_equal(got_a.view(np.uint8), want_ac.view(np.uint8))


def _cesm_blobs():
    """The CESM configuration's five stand-in fields at its rehearsal
    shape (60x120), QT at 1E-3 with verify: one monolithic DPK container
    each."""
    import dctz_tpu_torch as dz
    from benchmark.data import grf

    cfgj = json.loads((ROOT / "benchmark/configs/cesm-atm-qt.json").read_text())
    cfg = dz.CodecConfig(mode="qt", error_bound=1e-3, container="v2",
                         ids_codec="device", verify=True)
    for i in range(len(cfgj["fields"])):
        x = grf.make_field(cfgj, i, 2147500101, "cpu",
                           shape=cfgj["rehearsal"]["shape"]).numpy()
        yield dz.compress(x, config=cfg, device="cpu")


def _nyx_blob():
    """A NYX-shaped DTZS stream: baryon_density at the configuration's
    rehearsal shape (32^3) in its rehearsal frames (4096 samples), EC at
    1E-3 with verify: eight DPK frames."""
    import dctz_tpu_torch as dz
    from benchmark.data import grf

    cfgj = json.loads((ROOT / "benchmark/configs/nyx-512-ec.json").read_text())
    reh = cfgj["rehearsal"]
    cfg = dz.CodecConfig(mode="ec", error_bound=1e-3, container="v2",
                         ids_codec="device", verify=True,
                         segment_elems=reh["segment_elems"])
    x = grf.make_field(cfgj, 0, 2147500101, "cpu", shape=reh["shape"]).numpy()
    return dz.compress(x, config=cfg, device="cpu")


def _host_padded_decode(blob: bytes) -> np.ndarray:
    """A container's decode fed by rows padded on the host
    (torch_common.host_padded_arrays), through the same device stage
    (api._decode_device_dpk) on the CPU."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import container as ct

    header, streams, qtable, _cb = ct.parse_v2(blob)
    arrays, (n_stream, tile_b, cw, cfg) = host_padded_arrays(header, streams)
    dev, sf, qt = api._to_device(arrays, header,
                                 qtable if header.mode == "qt" else None,
                                 torch.device("cpu"))
    x = api._decode_device_dpk(*dev, n_stream, cfg, tile_b, cw, sf, header.dcd, qt)
    return x[: header.num_elements].numpy()


@pytest.mark.parametrize("cell", ["cesm", "nyx"])
def test_tight_upload_decodes_as_host_rows(cell, monkeypatch):
    """decompress of the CESM stand-ins and of a NYX-shaped stream equals,
    bit for bit, a decode fed by host-padded rows; the twin lays out each
    container's rows once (rows_laid_on_device: one a container, one a
    frame) and the host pads nothing (entropy.pad_row_prefixes raises)."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import entropy
    from dctz_tpu_torch.utils import timing
    from torch_common import frames_of

    blobs = list(_cesm_blobs()) if cell == "cesm" else [_nyx_blob()]
    want = [np.concatenate([_host_padded_decode(f) for f in frames_of(b)])
            for b in blobs]

    def refuse(*_a, **_k):
        raise AssertionError("the whole-container decode padded rows on the host")

    monkeypatch.setattr(entropy, "pad_row_prefixes", refuse)
    for blob, ref in zip(blobs, want):
        t = timing.StageTimer()
        got = dz.decompress(blob, device="cpu", timer=t)
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
        assert t.counts["rows_laid_on_device"] == len(frames_of(blob))
    assert len(frames_of(blobs[0])) == (1 if cell == "cesm" else 8)
