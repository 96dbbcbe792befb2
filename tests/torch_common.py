"""Helpers shared by the port's tests, free of jax, so that the card's tests
(tests/test_torch_cuda.py, run without tests/conftest.py on a machine that
has no jax) use them too: the container comparisons by which
tests/test_torch_oracle.py holds the port's containers to the reference's
and the card's tests hold the card's to the CPU's, the byte positions the
robustness tests flip, and the configuration generators of the soak tests
(tests/test_soak.py's, draw for draw)."""

import numpy as np
import torch

#: the v1 header's bytes that no check covers (dtype tag, element count,
#: error bound, padding, scaling factor, mean, the unused tail field): a
#: flip there decodes, in the reference too; every other byte of a v1
#: container is checked by its length fields or zlib's adler32
V1_UNCHECKED = frozenset(range(0, 16)) | frozenset(range(20, 40)) | frozenset(range(52, 56))
#: a DTZS stream's payload positions flipped (a seeded sample: every flip
#: in the second frame decodes the first one before it raises)
DTZS_PAYLOAD_SAMPLE = 1500

#: the headers' mean, a float32 sum divided by n, agrees within MEAN_ULPS
#: ulp of the mean |x|: XLA and torch add the float32 samples in other
#: orders, and the rounding of a reordered sum scales with the summands'
#: magnitudes, not with the (cancelling) total
MEAN_ULPS = 4


def assert_mean_close(h_port, h_ref, x: np.ndarray, ulps: float = MEAN_ULPS) -> None:
    """The headers' means within `ulps` ulp of float32(mean |x|)."""
    lim = ulps * float(np.spacing(np.float32(np.abs(x).mean())))
    assert abs(h_port.mean - h_ref.mean) <= lim, (h_port.mean, h_ref.mean, lim)


def frames_of(blob: bytes) -> list:
    """The containers of a blob: a DTZS stream's frames, else the blob."""
    from dctz_tpu_torch import stream

    if blob[:4] != b"DTZS":
        return [blob]
    off, out = stream._HDR.size, []
    while True:
        (flen,) = stream._FRAME.unpack_from(blob, off)
        off += stream._FRAME.size
        if not flen:
            return out
        out.append(blob[off : off + flen])
        off += flen


def parse_any(blob: bytes):
    """(header, sections, qtable) of a v1 or v2 container."""
    from dctz_tpu_torch.core import container as ct

    if ct.detect_format(blob) == "v1":
        header, *streams, qtable = ct.parse_v1(blob)
        return header, tuple(streams), qtable
    header, streams, qtable, _cb = ct.parse_v2(blob)
    return header, streams, qtable


def assert_byte_equal(port: bytes, ref: bytes, x: np.ndarray,
                      edge_flips: bool = False, qtable_rtol: float = 0.0,
                      mean_ulps: float = MEAN_ULPS) -> None:
    """The port's container (or stream) equals the reference's byte for
    byte but for the header's mean: frame by frame the same header, the
    same sections and the same qtable bytes; the mean of float32 data
    within MEAN_ULPS (assert_mean_close), of float64 data not compared (a
    sum in another order; tests/test_torch_f64.py's rule).

    edge_flips: for DPK frames of the fused route, whose reference is the
    Pallas kernel in interpret mode: its forward DCT runs on the
    block-diagonal 128-lane basis and can differ from any matmul of the
    64-point basis by an ulp, which moves a coefficient lying within that
    of a bin edge to the next bin (tests/test_torch_v1.py's rule). A frame
    whose sections differ must then decode to the same ids but at most
    1e-4 of its positions (and one), the rest of its header equal.

    qtable_rtol: for two float64 arithmetics (the card's and the CPU's), a
    float64 QT qtable within this relative difference, its maxima being of
    coefficients that differ by an ulp (tests/test_parity_native.py's rule,
    1e-15); the sections stay byte for byte. mean_ulps: the float32
    mean's budget (assert_mean_close)."""
    import dataclasses

    assert (port[:4] == b"DTZS") == (ref[:4] == b"DTZS")
    pf, rf = frames_of(port), frames_of(ref)
    assert len(pf) == len(rf)
    for a, b in zip(pf, rf):
        hp, sp, qp = parse_any(a)
        hr, sr, qr = parse_any(b)
        assert (qp is None) == (qr is None)
        if qp is not None and qtable_rtol and qp.dtype == np.float64:
            rel = np.abs(qp - qr) / np.maximum(np.abs(qr), np.finfo(np.float64).tiny)
            assert rel.max() <= qtable_rtol, rel.max()
        elif qp is not None:
            assert qp.tobytes() == qr.tobytes()
        if hp.dtype == np.float32:
            assert_mean_close(hp, hr, x, mean_ulps)
        if edge_flips and hp.dpk and sp != sr:
            keep = dict(mean=0.0, ac_count=0)
            assert (dataclasses.replace(hp, **keep)
                    == dataclasses.replace(hr, **keep))
            ids_p, ids_r = _dpk_ids(a), _dpk_ids(b)
            flips = int((ids_p != ids_r).sum())
            assert 0 < flips <= max(1, 1e-4 * ids_p.size), flips
            continue
        assert (dataclasses.replace(hp, mean=0.0)
                == dataclasses.replace(hr, mean=0.0)), (hp, hr)
        assert len(sp) == len(sr)
        for i, (s_p, s_r) in enumerate(zip(sp, sr)):
            assert s_p == s_r, f"section {i} differs"


def host_padded_arrays(header, streams):
    """A DPK container's decode inputs padded on the host, as the port's
    host stage made them before kernel N laid the rows out on the device:
    ((width, packed rows, exception rows, DC, AC rows), (n_stream, tile_b,
    cw, cfg)), DC as (4, nblk) byte planes or (nblk,) of the stored dtype,
    AC as (4, nc, capc) byte planes or (nc, capc) of the stored dtype
    (api._dpk_host_rebuild, entropy.pad_row_prefixes)."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import entropy

    (width, rows, exc_rows, dc_raw, ac_raw, n_stream, tile_b, cw, ac_counts,
     nblk) = api._dpk_host_rebuild(header, streams)
    cfg = api._header_config(header)
    stored = np.dtype(np.float32)
    if isinstance(dc_raw, tuple):
        dc = np.stack([np.frombuffer(p, np.uint8, nblk) for p in dc_raw[1]])
    else:
        stored, cfg = api._stored_dtype(header, len(dc_raw), nblk, cfg)
        dc = np.frombuffer(dc_raw, dtype=stored, count=nblk)
    capc = api._capc_tier(int(ac_counts.max()) if ac_counts.size else 0, cw)
    if isinstance(ac_raw, tuple):
        pls = [np.frombuffer(p, np.uint8, header.ac_count) for p in ac_raw[1]]
        ac = entropy.pad_row_prefixes(
            np.concatenate(pls), np.tile(ac_counts, len(pls)), capc, np.uint8
        ).reshape(len(pls), ac_counts.size, capc)
    else:
        ac = np.frombuffer(ac_raw, dtype=stored, count=header.ac_count)
        ac = entropy.pad_row_prefixes(ac, ac_counts, capc, stored)
    return (width, rows, exc_rows, dc, ac), (n_stream, tile_b, cw, cfg)


def _dpk_ids(blob: bytes) -> np.ndarray:
    """The bin-id grid of a DPK container (the port's plain unpack, byte
    for byte the reference's: test_torch_dpk_decode.py)."""
    from dctz_tpu_torch import api
    from dctz_tpu_torch.ops import idpack

    from dctz_tpu_torch.core import container as ct

    header, streams, _q, _cb = ct.parse_v2(blob)
    (width, rows, exc, *_rest), (n_stream, tile_b, cw, cfg) = (
        host_padded_arrays(header, streams))
    nblk = -(-n_stream // cfg.block_size)
    return idpack.unpack_ids(*(torch.from_numpy(np.array(a)) for a in
                               (width, rows, exc)),
                             nblk, cfg.block_size, tile_b, cw).numpy()


def roundtrip_configs(seed: int):
    """tests/test_soak.py::test_random_config_roundtrips' draws for one
    seed, in its order: (x, CodecConfig keyword arguments) ten times."""
    rng = np.random.default_rng(1000 + seed)
    for _ in range(10):
        n = int(rng.integers(1, 50000))
        dtype = rng.choice([np.float32, np.float64])
        kind = int(rng.integers(0, 4))
        if kind == 0:
            x = rng.standard_normal(n) * 10.0 ** int(rng.integers(-6, 6))
        elif kind == 1:
            x = np.sin(np.linspace(0, int(rng.integers(1, 300)), n)) * 100
        elif kind == 2:
            x = np.full(n, float(rng.standard_normal()) * 42)
        else:
            x = rng.standard_normal(n) * 0.01
            x[rng.random(n) < 0.01] *= 1e4
        x = x.astype(dtype)
        eb = float(rng.choice([1e-3, 1e-4, 3.3e-4]))
        kw = dict(
            mode=str(rng.choice(["ec", "qt"])),
            error_bound=eb,
            container=str(rng.choice(["v1", "v2"])),
            chunk_bytes=int(rng.choice([4096, 1 << 16])),
            shuffle=bool(rng.integers(0, 2)),
            ids4=bool(rng.integers(0, 2)),
            ids_codec=str(rng.choice(["auto", "deflate"])),
        )
        yield x, kw


def fused_configs(seed: int):
    """tests/test_soak.py::test_random_config_roundtrips_fused' draws for
    one seed, in its order: (x, CodecConfig keyword arguments) five times."""
    rng = np.random.default_rng(7000 + seed)
    for _ in range(5):
        n = int(rng.integers(1000, 200000))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            x = rng.standard_normal(n) * 10.0
        elif kind == 1:
            x = np.sin(np.linspace(0, 80, n)) * 100
        else:
            x = rng.standard_normal(n) * 0.01
            x[rng.random(n) < 0.01] *= 1e4
        x = x.astype(np.float32)
        eb = float(rng.choice([1e-3, 1e-4]))
        kw = dict(
            mode=str(rng.choice(["ec", "qt"])),
            error_bound=eb,
            container="v2",
            ids_codec="device",
            verify=bool(rng.integers(0, 2)),
            segment_elems=(
                int(rng.choice([1 << 15, 1 << 16]))
                if rng.integers(0, 2)
                else None
            ),
        )
        yield x, kw


def soak_rel_ok(x: np.ndarray, y: np.ndarray, kw: dict, fused: bool = False) -> bool:
    """tests/test_soak.py's bound on a decode: the error over the span within
    the bound for verified EC in the fused soak, else within max(20 eb,
    1e-3) (QT loosens outlier precision by design, docs/numerics.md)."""
    span = float(x.max() - x.min())
    if span <= 0:
        return True
    rel = float(np.abs(x - y).max()) / span
    eb = kw["error_bound"]
    if fused and kw["verify"] and kw["mode"] == "ec":
        return rel <= eb * 1.001
    return rel <= max(eb * 20, 1e-3)


def frame_spans(blob: bytes) -> list:
    """(start, end) of each frame body of a DTZS stream."""
    spans, off = [], 16
    while True:
        length = int.from_bytes(blob[off:off + 8], "little")
        off += 8
        if not length:
            return spans
        spans.append((off, off + length))
        off += length


def flip_positions(blob: bytes, seed: int = 0) -> list:
    """Every byte of a container; of a DTZS stream, every byte of the stream
    header, the frame length fields and each frame's first and last 512
    bytes (its fixed header, chunk tables and crcs; its last chunk), and a
    seeded sample of DTZS_PAYLOAD_SAMPLE positions among the rest."""
    if blob[:4] != b"DTZS":
        return list(range(len(blob)))
    every = set(range(16))
    for start, end in frame_spans(blob):
        every |= set(range(start - 8, min(start + 512, end)))
        every |= set(range(max(start, end - 512), end))
    every |= {len(blob) - k for k in range(1, 9)}  # the terminating length
    rest = np.setdiff1d(np.arange(len(blob)), np.fromiter(every, int))
    rng = np.random.default_rng(seed)
    sample = rng.choice(rest, min(DTZS_PAYLOAD_SAMPLE, rest.size), replace=False)
    return sorted(every | {int(p) for p in sample})


def frames_intact_before(blob: bytes, pos: int) -> int:
    """The frames of a DTZS stream that a flip at pos leaves intact and that
    a reader decodes before it meets the flip: those wholly before pos, or
    every frame when pos lies in the stream header's element count (bytes
    8-15, checked against the frames only once they are restored)."""
    spans = frame_spans(blob)
    if 8 <= pos < 16:
        return len(spans)
    return sum(end <= pos for _start, end in spans)
