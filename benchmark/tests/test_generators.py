"""The fields come from the seed alone: the same seed gives the same
fields, another seed another arrangement of the same values."""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.data import grf

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONFIGS = ["nyx-512-ec", "cesm-atm-qt"]


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_fields_deterministic_per_seed_and_differ_across_seeds(name):
    cfg = _config(name)
    shape = cfg["rehearsal"]["shape"]
    big = 2**31 + 12345  # larger than 32 signed bits
    for i in range(len(cfg["fields"])):
        a = grf.make_field(cfg, i, big, "cpu", shape).numpy()
        b = grf.make_field(cfg, i, big, "cpu", shape).numpy()
        c = grf.make_field(cfg, i, 7, "cpu", shape).numpy()
        assert a.dtype == np.float32 and a.size == np.prod(shape)
        assert np.array_equal(a, b)
        assert not np.array_equal(a, c)
        # the same multiset of values: only the arrangement moves
        assert np.array_equal(np.sort(a), np.sort(c))


def test_field_seeds_are_63_bit_for_any_seed():
    for seed in (0, -1, 2**31 + 1, 2**70):
        for i in range(6):
            s = grf.field_seed(seed, i)
            assert 0 <= s < 2**63
            torch.Generator().manual_seed(s)
