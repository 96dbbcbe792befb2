"""Parser robustness of the port (dctz_tpu_torch, device="cpu"): the eleven
checks of tests/test_robustness.py with the same assertions, malformed
containers raising clean exceptions (never SystemExit or MemoryError, and
ValueError naming crc, truncation, corruption or the version where the
reference asserts it). The every-byte flip also runs on a host-coded v2
container, a DPK v2 container and a two-frame DPK DTZS stream; a v1
container's payload flips raise too (its header carries no checksum, in
either package or in the C codec). On the card, tests/test_torch_cuda.py
decodes flipped copies on device="cuda" and counts the kernels launched.
"""

import io
import warnings

import numpy as np
import pytest
import torch

import dctz_tpu_torch as dz
from dctz_tpu_torch.config import CodecConfig
from dctz_tpu_torch.core import container as ct
from torch_common import V1_UNCHECKED, flip_positions, frame_spans

torch.set_num_threads(2)

def _clean(e: BaseException) -> bool:
    return not isinstance(e, (SystemExit, MemoryError))


@pytest.fixture(scope="module")
def blobs():
    x = np.sin(np.linspace(0, 30, 5000))
    x32 = x.astype(np.float32)
    x_dtzs = np.sin(np.linspace(0, 300, 2 << 15)).astype(np.float32)
    return {
        "v1": dz.compress(x, 1e-3, "ec", device="cpu"),
        # the reference's case: "auto" ids, which the port codes on the
        # device (DPK) on every device
        "v2": dz.compress(x, config=CodecConfig(error_bound=1e-3, container="v2"),
                          device="cpu"),
        "v2_deflate": dz.compress(x, config=CodecConfig(error_bound=1e-3, container="v2",
                                                        ids_codec="deflate"), device="cpu"),
        "dpk": dz.compress(x32, config=CodecConfig(error_bound=1e-3, container="v2",
                                                   ids_codec="device"), device="cpu"),
        "dtzs": dz.compress(x_dtzs, config=CodecConfig(
            error_bound=1e-3, container="v2", ids_codec="device", segment_elems=1 << 15),
            device="cpu"),
    }


def test_empty_blob():
    with pytest.raises(ValueError):
        dz.decompress(b"", device="cpu")


def test_garbage_blob():
    with pytest.raises(Exception) as ei:
        dz.decompress(b"\x00" * 200, device="cpu")
    assert _clean(ei.value)


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_truncated_blob(blobs, fmt):
    blob = blobs[fmt]
    for cut in (10, len(blob) // 2, len(blob) - 3):
        with pytest.raises(Exception) as ei:
            dz.decompress(blob[:cut], device="cpu")
        assert _clean(ei.value)


def test_v2_chunk_crc_detects_corruption(blobs):
    """A flipped byte inside a v2 chunk payload raises a crc ValueError at
    parse time."""
    blob = bytearray(blobs["v2"])
    for pos in (len(blob) // 2, len(blob) - 20):
        b = bytearray(blob)
        b[pos] ^= 0xFF
        with pytest.raises(ValueError, match="crc|truncated|corrupt"):
            ct.parse_v2(bytes(b))


@pytest.mark.parametrize("fmt", ["v2", "v2_deflate", "dpk", "dtzs"])
def test_v2_every_byte_flip_fails_loudly(blobs, fmt):
    """Single-byte corruption (XOR 0x5A) of any byte of a v2 container, a
    host-coded or DPK one, or of a DPK DTZS stream (flip_positions) must
    raise: the fixed header and chunk tables carry their own crc, payload
    chunks theirs, a stream's header and frame lengths are checked against
    its frames."""
    blob = bytes(blobs[fmt])
    for pos in flip_positions(blob):
        b = bytearray(blob)
        b[pos] ^= 0x5A
        try:
            dz.decompress(bytes(b), device="cpu")
        except Exception as e:
            assert _clean(e), (pos, e)
            continue
        raise AssertionError(f"byte {pos} flip decoded silently")


def test_v1_every_checked_byte_flip_fails_loudly(blobs):
    """A v1 container's flips raise everywhere but in the header fields no
    check covers (V1_UNCHECKED); those decode, as in the reference."""
    blob = bytes(blobs["v1"])
    silent = []
    for pos in range(len(blob)):
        b = bytearray(blob)
        b[pos] ^= 0x5A
        try:
            dz.decompress(bytes(b), device="cpu")
        except Exception as e:
            assert _clean(e), (pos, e)
            continue
        silent.append(pos)
    assert set(silent) <= V1_UNCHECKED, sorted(set(silent) - V1_UNCHECKED)


def test_v2_bad_version(blobs):
    blob = bytearray(blobs["v2"])
    blob[4] = 99  # version field
    with pytest.raises(ValueError, match="version"):
        ct.parse_v2(bytes(blob))


def test_v1_header_only():
    hdr = ct.pack_v1(
        ct.Header(
            dtype=np.dtype(np.float64),
            num_elements=100,
            error_bound=1e-3,
            ac_count=0,
            scaling_factor=1.0,
            mean=0.0,
            bindex_nbytes=0,
            dc_nbytes=0,
            ac_nbytes=0,
            mode="ec",
        ),
        b"",
        b"",
        b"",
        None,
    )
    # zero-length streams: inflate fails cleanly
    with pytest.raises(Exception) as ei:
        dz.decompress(hdr, device="cpu")
    assert _clean(ei.value)


def test_ids4_truncated_exceptions():
    """A packed ids4 stream referencing more exception bytes than the
    exception section holds must raise, not read out of bounds."""
    from dctz_tpu_torch.core import entropy

    packed = bytes([0xFF] * 8)  # 16 nibble-15 markers -> needs 16 exc bytes
    exc = bytes([255] * 3)  # ...but only 3 provided
    with pytest.raises(ValueError):
        entropy.unpack_ids4(packed, exc, 16)


def test_v1_rejects_nondefault_geometry():
    """v1 has no block_size/nbins fields; compress() must not emit a v1
    container that parse_v1 would mis-read."""
    x = np.sin(np.linspace(0, 10, 4096)).astype(np.float32)
    with pytest.warns(UserWarning, match="v1 containers"):
        blob = dz.compress(
            x, config=CodecConfig(error_bound=1e-3, container="v1", nbins=127),
            device="cpu",
        )
    assert ct.detect_format(blob) == "v2"  # auto-upgraded
    y = dz.decompress(blob, device="cpu")
    assert np.abs(x - y).max() < 0.5  # round-trips via v2, no corruption

    with pytest.warns(UserWarning, match="v1 containers"):
        blob = dz.compress(
            x,
            config=CodecConfig(error_bound=1e-3, container="v1", block_size=32),
            device="cpu",
        )
    assert ct.detect_format(blob) == "v2"
    y = dz.decompress(blob, device="cpu")
    assert y.shape == x.shape


def test_chunk_width_is_block_multiple():
    """chunk_width must return a block multiple for ANY geometry."""
    from dctz_tpu_torch.core.quantize import chunk_width

    for bs in (2, 16, 32, 48, 64, 100, 512, 1024):
        for nblk in (1, 2, 3, 5, 31, 100):
            cw = chunk_width(nblk * bs, bs)
            assert cw % bs == 0, (bs, nblk, cw)
            assert (nblk * bs) % cw == 0, (bs, nblk, cw)


def test_stream_truncated_frame():
    from dctz_tpu_torch import stream

    x = np.sin(np.linspace(0, 5, 1000))
    buf = io.BytesIO()
    stream.compress_stream(x, buf, 1e-3, "ec", device="cpu")
    data = buf.getvalue()
    with pytest.raises(Exception) as ei:
        list(stream.decompress_stream(io.BytesIO(data[: len(data) // 2]), device="cpu"))
    assert _clean(ei.value)


@pytest.mark.parametrize("pos", range(16))
def test_stream_header_flips_raise_value_errors(blobs, pos):
    """Every flip of a DTZS stream's 16-byte header raises ValueError,
    through decompress and decompress_sharded: the reserved field (bytes
    6-7) must be 0, and an element count (bytes 8-15) that no host can
    allocate is a corrupted header, not a MemoryError (the reference
    ignores the reserved field and allocates the count it reads)."""
    b = bytearray(blobs["dtzs"])
    b[pos] ^= 0x5A
    for decode in (lambda blob: dz.decompress(blob, device="cpu"),
                   lambda blob: dz.decompress_sharded(blob, mesh=["cpu"])):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            with pytest.raises(ValueError, match="stream|version|corrupt|truncated|container"):
                decode(bytes(b))


@pytest.mark.parametrize("mode", ["ec", "qt"])
def test_compress_stream_takes_the_references_arguments(mode):
    """stream.compress_stream(x, out, error_bound, mode) as dctz_tpu's writer
    takes them (no config: a v2 configuration of that mode and bound); each
    package decodes the other's stream within the bound."""
    import dctz_tpu
    from dctz_tpu import stream as jstream
    from dctz_tpu_torch import stream

    x = np.sin(np.linspace(0, 5, 3000)) * 7
    port, ref = io.BytesIO(), io.BytesIO()
    stream.compress_stream(x, port, 1e-4, mode, segment_elems=1024, device="cpu")
    jstream.compress_stream(x, ref, 1e-4, mode, segment_elems=1024)
    lim = 1e-4 * float(x.max() - x.min())
    for blob in (port.getvalue(), ref.getvalue()):
        assert blob[:4] == b"DTZS"
        for y in (dz.decompress(blob, device="cpu"), np.asarray(dctz_tpu.decompress(blob))):
            assert y.shape == x.shape and np.abs(y - x).max() <= lim
    for start, end in frame_spans(port.getvalue()):
        h = ct.parse_v2(port.getvalue()[start:end])[0]
        assert (h.mode, h.error_bound) == (mode, 1e-4)
