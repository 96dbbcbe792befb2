"""A non-default block size or bin count in the port against dctz_tpu,
under the oracle of test_torch_oracle.py (the fused dispatch forced, x64
off): block sizes 32, 48 and 128 with 63, 127 and 255 bins, EC and QT, in a
v1 configuration (which upgrades to v2, DPK under the oracle, and warns), host-coded v2 and DPK v2
(the XLA chain's DPK route, its id stream of the true length), on a length
that is no block multiple.

The fused kernels take blocks of 64 and 255 bins alone, so every case runs
the generic chain and none of kernels A-G (kernel_calls). Containers are
held byte for byte but for the mean with two float operations of the port
set to the reference's XLA CPU arithmetic (use_ref_arithmetic: the
transforms' products and the QT renormalization's rounding), and the
port's own containers decode both ways within the bound.
"""

import numpy as np
import pytest
import torch

from test_torch_oracle import (  # noqa: F401
    EPS32, assert_byte_equal, assert_mean_close, kernel_calls, oracle,
    parse_any, signal, use_ref_arithmetic,
)

torch.set_num_threads(2)

N = 3 * 4096 + 5
EB = 1e-3
FAMILIES = {
    "v1": dict(container="v1"),
    "host_coded": dict(container="v2", ids_codec="deflate"),
    "dpk": dict(container="v2", ids_codec="device"),
}


def _compress(pkg, x, kw, **extra):
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        blob = pkg.compress(x, config=pkg.CodecConfig(**kw), **extra)
    return blob, [str(w.message) for w in caught]


@pytest.mark.parametrize("bs", [32, 48, 128])
def test_forward_dct_within_budget_at_block_size(bs):
    """The port's own forward transform (no use_ref_arithmetic) at a block
    size other than 64 against dctz_tpu's, on a length whose last block is
    partial (the rem-point basis): fp32 sums in another order, within 32 ulp
    of max|xs| of each block and of the tail."""
    import jax.numpy as jnp
    from dctz_tpu.core import transform as jt
    from dctz_tpu_torch.core import transform as tt

    n = 97 * bs + bs // 3
    xs = signal(n, bs) / np.float32(10.0)
    main_r, tail_r = (np.asarray(a) for a in jt.forward(jnp.asarray(xs), bs))
    main_p, tail_p = tt.forward(torch.from_numpy(xs), bs)
    n_full = n // bs
    assert main_p.shape == main_r.shape == (n_full, bs)
    assert tail_p.shape == tail_r.shape == (n - n_full * bs,)
    budget = 32 * EPS32 * np.abs(xs[:n_full * bs].reshape(-1, bs)).max(
        axis=1, keepdims=True)
    assert np.all(np.abs(main_p.numpy() - main_r) <= budget)
    tail_budget = 32 * EPS32 * np.abs(xs[n_full * bs:]).max()
    assert np.all(np.abs(tail_p.numpy() - tail_r) <= tail_budget)


@pytest.mark.parametrize("mode", ["ec", "qt"])
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("nbins", [63, 127, 255])
@pytest.mark.parametrize("bs", [32, 48, 128])
def test_geometry_matches_reference(oracle, monkeypatch, kernel_calls, bs,
                                    nbins, family, mode):
    import dctz_tpu
    import dctz_tpu_torch as dz
    from dctz_tpu_torch.core import container as ct

    x = signal(N, bs + nbins)
    kw = dict(FAMILIES[family], mode=mode, error_bound=EB, verify=True,
              block_size=bs, nbins=nbins, segment_elems=0)
    ref, wr = _compress(dctz_tpu, x, kw)
    port, wp = _compress(dz, x, kw, device="cpu")
    assert wp == wr
    assert bool(wp) == (family == "v1")  # the upgrade's warning
    assert not any(k in kernel_calls for k in ("A", "B", "C", "D", "E", "FG"))

    # the port's own container: its header but for the mean and the
    # counts, its size within 0.5%, decoded both ways within the bound
    hp, hr = parse_any(port)[0], parse_any(ref)[0]
    assert ct.detect_format(port) == "v2"
    assert (hp.block_size, hp.nbins, hp.dpk, hp.num_elements) == (
        hr.block_size, hr.nbins, hr.dpk, hr.num_elements) == (
        bs, nbins, family != "host_coded", N)
    assert_mean_close(hp, hr, x)
    assert abs(len(port) / len(ref) - 1.0) <= 0.005
    lim = EB * float(x.max() - x.min())
    for y in (dz.decompress(port, device="cpu"), np.asarray(dctz_tpu.decompress(port)),
              dz.decompress(ref, device="cpu")):
        assert y.dtype == np.float32 and np.abs(y - x).max() <= lim
    want = np.asarray(dctz_tpu.decompress(ref))
    got = dz.decompress(ref, device="cpu")
    assert np.abs(got - want).max() <= 32 * EPS32 * hr.scaling_factor

    # with the reference's transform products, byte for byte
    use_ref_arithmetic(monkeypatch)
    same, _w = _compress(dz, x, kw, device="cpu")
    assert_byte_equal(same, ref, x)


@pytest.mark.parametrize("bs,cw", [(32, 512), (48, 480), (128, 512)])
def test_dpk_chunk_width_and_true_length(oracle, bs, cw):
    """The DPK container of a non-default block size records the chunk
    width of its block-padded length and the true length n, as the
    reference's XLA chain does: 48 gives rows of 480 (a multiple of 32,
    which kernel J takes on the card; the reference's own kernel does not,
    and its sort writes the same bytes)."""
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import container as ct

    n = bs * 160 * 4 - 3
    x = signal(n, bs)
    blob = dz.compress(x, config=dz.CodecConfig(container="v2", block_size=bs,
                                                verify=True, segment_elems=0),
                       device="cpu")
    header, streams, _q, _cb = ct.parse_v2(blob)
    assert api._dpk_host_rebuild(header, streams)[5:8] == (n, 256, cw)


@pytest.mark.parametrize("bs", [32, 48])
def test_geometry_dtzs_frames(oracle, bs):
    """A segmented non-default geometry writes host-coded v2 frames of the
    generic chain (the DPK segment kernels take blocks of 64 alone), the
    same frames as the reference's writer."""
    import dctz_tpu
    import dctz_tpu_torch as dz

    x = signal(N, bs)
    kw = dict(container="v2", ids_codec="device", block_size=bs, nbins=127,
              verify=True, segment_elems=4096)
    mp = pytest.MonkeyPatch()
    try:
        use_ref_arithmetic(mp)
        port = dz.compress(x, config=dz.CodecConfig(**kw), device="cpu")
    finally:
        mp.undo()
    ref = dctz_tpu.compress(x, config=dctz_tpu.CodecConfig(**kw))
    assert port[:4] == b"DTZS"
    assert_byte_equal(port, ref, x)
    y = dz.decompress(port, device="cpu")
    assert np.abs(y - x).max() <= EB * float(x.max() - x.min())
