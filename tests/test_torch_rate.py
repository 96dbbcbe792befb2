"""rate="auto" and brsf != 1 in the port against dctz_tpu, under the oracle
of test_torch_oracle.py (the fused dispatch forced, x64 off).

The brsf grid and its warning, the auto-rate sample and ladder, and the
container upgrades are checked on their own. Whole containers are held
byte for byte but for the mean (assert_byte_equal) with two float
operations of the port set to the reference's XLA CPU arithmetic
(ref_arithmetic: the transforms' products and the QT renormalization's
rounding); the DPK frames of the fused route are held to the Pallas
kernel's own transform, whose block-diagonal product can move a
coefficient lying within an ulp of a bin edge (assert_byte_equal's
edge_flips). Both packages decode each other's containers within the
bound. brsf != 1 runs kernel A's plain version on DPK v2 and the generic
chain on host-coded v2, never F's or G's (kernel_calls).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from test_auto_rate import _smooth
from test_torch_oracle import (  # noqa: F401
    EPS32, assert_byte_equal, frames_of, kernel_calls, oracle, parse_any,
    ref_arithmetic, signal, slice_cfg,
)

torch.set_num_threads(2)

N = 3 * 4096 + 5  # the last block partial, the 1024 pad quantum not met


def _both(x, kw):
    """((the port's container, its warnings' messages), (dctz_tpu's, its
    warnings' messages)) of x under the config kw."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    out = []
    for pkg, call in ((dctz_tpu, lambda c: dctz_tpu.compress(x, config=c)),
                      (dz, lambda c: dz.compress(x, config=c, device="cpu"))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            blob = call(pkg.CodecConfig(**kw))
        out.append((blob, [str(w.message) for w in caught]))
    return out[::-1]


def _decodes(x, port, ref, eb):
    """Each package decodes both containers within the bound; the two
    decodes of the reference's container agree within 32 ulp of sf."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    lim = eb * float(x.max() - x.min())
    for blob in (port, ref):
        for y in (dz.decompress(blob, device="cpu"),
                  np.asarray(dctz_tpu.decompress(blob))):
            assert y.shape == x.shape and np.abs(y - x).max() <= lim
    got, want = dz.decompress(ref, device="cpu"), np.asarray(dctz_tpu.decompress(ref))
    sf = parse_any(frames_of(ref)[0])[0].scaling_factor
    assert np.abs(got - want).max() <= 32 * EPS32 * sf


@pytest.mark.parametrize("brsf", [2 ** (3 / 8), 1.3, 8.0, 0.7, 3.0e5, 1e-7, 1.0])
def test_quantize_brsf_grid_and_warning(brsf):
    """The snap to the header's 2**(k/8) grid and its warning, against
    dctz_tpu's _quantize_brsf (k clamped to 1..255)."""
    from dctz_tpu import api as ja
    from dctz_tpu.config import CodecConfig as JCfg
    from dctz_tpu_torch import api as ta
    from dctz_tpu_torch.config import CodecConfig as TCfg

    got, want = [], []
    for fn, cfg, out in ((ta._quantize_brsf, TCfg(brsf=brsf), got),
                         (ja._quantize_brsf, JCfg(brsf=brsf), want)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out.append(fn(cfg).brsf)
        out.append([str(w.message) for w in caught])
    assert got == want
    assert bool(got[1]) == (brsf not in (2 ** (3 / 8), 8.0, 1.0))
    k = round(np.log2(got[0]) * 8)
    assert got[0] == 2.0 ** (k / 8) and 1 <= k + 128 <= 255


@pytest.mark.parametrize("n,bs", [(4096, 64), (40000 + 7, 64), (40000 + 7, 48),
                                  (5 * 4096, 128)])
def test_rate_sample_matches_reference(monkeypatch, n, bs):
    """The trials' sample: the whole array up to _AUTO_SAMPLE_ELEMS (here
    cut to 8192 in both packages), else eight block-aligned slices, equal
    to dctz_tpu's; a tensor is cut where it lies."""
    from dctz_tpu import api as ja
    from dctz_tpu_torch import api as ta

    monkeypatch.setattr(ja, "_AUTO_SAMPLE_ELEMS", 8192)
    monkeypatch.setattr(ta, "_AUTO_SAMPLE_ELEMS", 8192)
    x = signal(n, n)
    want = np.asarray(ja._rate_sample(x, n, bs))
    got = ta._rate_sample(torch.from_numpy(x), n, bs)
    assert isinstance(got, torch.Tensor)
    assert got.numpy().tobytes() == want.tobytes()
    assert ta._rate_sample(x, n, bs).tobytes() == want.tobytes()
    assert (got.numel() < n) == (n > 8192)


#: scripted trial outcomes: the sizes of the ladder's rungs, and the rung
#: (if any) whose trial warns that the bound failed
LADDERS = {
    "falls_then_rises": ([100, 90, 80, 82, 95, 200, 300, 400], None),
    "flat_within_two_percent": ([100, 100, 101, 101.9, 101.95, 99, 150, 160], None),
    "bound_fails_at_8": ([100, 90, 80, 70, 60, 50, 40, 30], 8.0),
    "bound_fails_at_1": ([100, 90, 80, 70, 60, 50, 40, 30], 1.0),
    "falls_to_the_end": ([100, 90, 80, 70, 60, 50, 40, 30], None),
}


@pytest.mark.parametrize("name", list(LADDERS))
def test_ladder_stops_where_the_reference_stops(monkeypatch, name):
    """_auto_rate_brsf of both packages over the same scripted trials: the
    same rungs tried, the same brsf chosen; a trial that warns of the
    pointwise bound ends the ladder and is never chosen."""
    from dctz_tpu import api as ja
    from dctz_tpu_torch import api as ta

    sizes, fails = LADDERS[name]
    chosen, tried = {}, {}
    for pkg in (ja, ta):
        seen = []

        def fake(sample, *, config, device=None, seen=seen, pkg=pkg):
            seen.append(config.brsf)
            assert config.verify and config.segment_elems is None
            if config.brsf == fails:
                warnings.warn("verify-repair could not fully satisfy the "
                              "pointwise bound (float32-truncation floor)")
            return b"x" * int(sizes[pkg.AUTO_RATE_LADDER.index(config.brsf)] * 10)

        monkeypatch.setattr(pkg, "compress", fake)
        x = torch.zeros(4096) if pkg is ta else np.zeros(4096, np.float32)
        cfg = pkg.CodecConfig(rate="auto", container="v2")
        chosen[pkg] = pkg._auto_rate_brsf(x, 4096, cfg)
        tried[pkg] = seen
    assert ta.AUTO_RATE_LADDER == ja.AUTO_RATE_LADDER
    assert chosen[ta] == chosen[ja] and tried[ta] == tried[ja]
    if fails is not None:
        assert tried[ta][-1] == fails and (chosen[ta] != fails or fails == 1.0)


@pytest.mark.parametrize("kw,expect", [
    (dict(rate="auto", container="v1"), ["rate='auto' needs the v2 container"]),
    (dict(brsf=2.0, container="v1"), ["v1 containers cannot record brsf"]),
    (dict(brsf=1.5, container="v1"), ["v1 containers cannot record brsf",
                                       "brsf 1.5 quantized to"]),
    (dict(rate="auto", container="v1", nbins=127),
     ["rate='auto' needs the v2 container"]),
])
def test_upgrades_warn_as_reference(oracle, kw, expect):
    """The compress prologue's upgrades, in the reference's order: the same
    warnings, a v2 container, and for rate="auto" verify forced on (the
    trials' warnings are caught inside; the final encode verifies)."""
    from dctz_tpu_torch.core import container as ct

    x = signal(N, 4)
    # verify off where rate="auto" must turn it on
    base = dict(error_bound=1e-3, segment_elems=0, verify="brsf" in kw)
    (port, wp), (ref, wr) = _both(x, dict(base, **kw))
    assert wp == wr
    assert [any(e in w for w in wp) for e in expect] == [True] * len(expect)
    for blob in (port, ref):
        assert ct.detect_format(blob) == "v2"
    assert parse_any(port)[0].brsf == parse_any(ref)[0].brsf
    _decodes(x, port, ref, 1e-3)


#: monolithic and DTZS, EC and QT: the DPK route (kernels A, B; E in QT)
AUTO = {
    "ec": dict(mode="ec", segment_elems=0),
    "qt": dict(mode="qt", segment_elems=0),
    "ec_dtzs": dict(mode="ec", segment_elems=1 << 14),
    "qt_dtzs": dict(mode="qt", segment_elems=1 << 14),
}


@pytest.mark.parametrize("eb", [1e-3, 1e-5])
@pytest.mark.parametrize("case", list(AUTO))
def test_auto_rate_matches_reference(oracle, ref_arithmetic, case, eb):
    """rate="auto" on test_auto_rate's smooth input: the chosen brsf and the
    container (a DTZS stream frame by frame) equal the reference's; the
    chosen geometry widens the bins at 1e-3, and both packages decode each
    other's container within the bound."""
    x = _smooth(1 << 16)
    kw = dict(AUTO[case], error_bound=eb, container="v2", ids_codec="device",
              rate="auto")
    (port, _wp), (ref, _wr) = _both(x, kw)
    assert_byte_equal(port, ref, x, edge_flips=True)
    brsf = parse_any(frames_of(port)[0])[0].brsf
    if eb == 1e-3:
        assert brsf > 1.0
    _decodes(x, port, ref, eb)


def test_auto_rate_records_its_trials(oracle):
    """StageTimer.rate_trials collects (brsf, size, seconds) per trial and
    the "rate" stage their time; the sizes are the trials' containers."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.utils.timing import StageTimer

    x = _smooth(1 << 14)
    timer = StageTimer()
    blob = dz.compress(x, config=dz.CodecConfig(container="v2", rate="auto",
                                                segment_elems=0),
                       timer=timer, device="cpu")
    brsfs = [t[0] for t in timer.rate_trials]
    assert brsfs == list(dz.api.AUTO_RATE_LADDER[:len(brsfs)])
    assert timer.stages["rate"] >= sum(t[2] for t in timer.rate_trials)
    # the sample is the whole array, so the chosen trial's container is the
    # final one
    sizes = dict((b, s) for b, s, _t in timer.rate_trials)
    assert len(blob) == sizes[parse_any(blob)[0].brsf]


#: brsf on the DPK route (kernel A's twin) and on host-coded v2 (the
#: generic chain), EC and QT
BRSF_FAMILIES = {
    "dpk": dict(container="v2", ids_codec="device"),
    "host_coded": dict(container="v2", ids_codec="deflate"),
    "dpk_dtzs": dict(container="v2", ids_codec="device", segment_elems=4096),
}


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("family", list(BRSF_FAMILIES))
@pytest.mark.parametrize("brsf", [2 ** (3 / 8), 8.0])
def test_brsf_containers_match_reference(oracle, ref_arithmetic, kernel_calls,
                                         brsf, family, mode):
    """brsf on the header's grid, verify on: the container equals the
    reference's (ref_arithmetic), kernel A's plain version runs on DPK v2
    and the generic chain on host-coded v2, never F's or G's, and both
    packages decode each other's container within the bound."""
    x = signal(N, 7)
    kw = dict(dict(segment_elems=0), **BRSF_FAMILIES[family], mode=mode,
              error_bound=1e-3, verify=True, brsf=brsf)
    (port, wp), (ref, wr) = _both(x, kw)
    assert wp == wr == []  # on the grid: no snap, no upgrade
    assert_byte_equal(port, ref, x, edge_flips=True)
    frames = frames_of(port)
    assert all(parse_any(f)[0].brsf == brsf for f in frames)
    assert "FG" not in kernel_calls
    if family.startswith("dpk"):
        assert kernel_calls["A"] == kernel_calls["B"] >= len(frames)
        assert kernel_calls.get("E", 0) == (mode == "qt") * len(frames)
    else:
        assert "A" not in kernel_calls and "E" not in kernel_calls
    _decodes(x, port, ref, 1e-3)


def test_brsf_off_grid_snaps_as_reference(oracle, ref_arithmetic):
    """brsf=1.5 on DPK v2: both packages warn, snap to 2**(5/8) and write
    the same container."""
    import dctz_tpu

    x = signal(N, 8)
    cfg = slice_cfg(dctz_tpu, brsf=1.5)
    (port, wp), (ref, wr) = _both(
        x, {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    assert wp == wr and "quantized to" in wp[0]
    assert parse_any(port)[0].brsf == 2 ** (5 / 8)
    assert_byte_equal(port, ref, x, edge_flips=True)
