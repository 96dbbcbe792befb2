"""The port's multi-rank paths (dctz_tpu_torch.parallel.multihost over
torch.distributed with the gloo backend, each rank a mesh of two CPU
shards) against dctz_tpu's (tests/_mh_worker.py: jax.distributed, two
virtual CPU devices a process), and the tile-range DPK decode
(api._decompress_dpk_range) against the reference's.

The ranks run this file as a script (the __main__ block at the end), which
imports neither jax nor dctz_tpu. Every subprocess and every communicate has
its own timeout. The workers' data are float64 (x64 on in the reference's),
so frames are held by tests/test_torch_f64.py's rules: EC after
util.canonical, QT by sections and a qtable within rtol 1e-15; decodes of
float64 within 8 eps64 * max|y| of the reference's.
"""

import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve()
REF_WORKER = HERE.parent / "_mh_worker.py"
TIMEOUT = 240  # seconds, per subprocess
EB = 1e-3


@pytest.fixture
def ref_arithmetic(monkeypatch):
    """test_torch_oracle.ref_arithmetic (that module imports jax, which the
    ranks of this file must not)."""
    from test_torch_oracle import use_ref_arithmetic

    use_ref_arithmetic(monkeypatch)


def make_data(n: int) -> np.ndarray:
    """tests/_mh_worker.make_data (that module imports jax)."""
    t = np.linspace(0, 40, n)
    x = np.sin(t) * 25 + np.sin(t * 17.3) * 2
    spikes = np.arange(n) % 997 == 0
    return np.where(spikes, x * 9, x).astype(np.float64)


def _rank_main(argv) -> None:
    """One rank: <rank> <world> <port> <n_total> <mode|restore> <codec>
    <out> <mesh: comma-separated devices> [stream]."""
    rank, world, port, n_total = (int(a) for a in argv[:4])
    mode, codec, out = argv[4:7]
    mesh = argv[7].split(",")
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from dctz_tpu_torch.config import CodecConfig
    from dctz_tpu_torch.ops import idpack
    from dctz_tpu_torch.parallel import multihost as mh

    mh.init(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
    assert mh.process_count() == world and mh.process_index() == rank
    if mode == "restore":
        res = mh.decompress_multihost(pathlib.Path(argv[8]).read_bytes(), mesh=mesh)
        np.savez(out, data=res.data, start=res.start,
                 frames=np.asarray(res.frames, np.int64))
    else:
        quantum = idpack.B_DEFAULT if codec == "device" else 1
        lo, hi = mh.host_slice(n_total, quantum_blocks=quantum, mesh=mesh)
        cfg = CodecConfig(mode=mode, error_bound=EB, container="v2", verify=True,
                          ids_codec=codec)
        part = mh.compress_multihost(make_data(n_total)[lo:min(hi, n_total)], n_total,
                                     config=cfg, mesh=mesh)
        pathlib.Path(out).write_bytes(part)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dctz_tpu")]
    assert not bad, bad
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argvs) -> None:
    """Run the processes together; each communicate has its own timeout,
    and a timeout or a failure in any process kills them all."""
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for a in argvs]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=TIMEOUT)


def _run(tmp_path, who: str, nproc: int, n_total: int, mode: str, codec: str,
         stream=None, tag: str = "", mesh: str = "cpu,cpu") -> list:
    """nproc ranks of the port (who="torch", each on `mesh`) or of the
    reference (who="jax", tests/_mh_worker.py: two virtual devices a
    process); returns their output paths."""
    port = _free_port()
    outs, argvs = [], []
    for r in range(nproc):
        restore = mode == "restore"
        out = tmp_path / f"{who}{tag}{'restore' if restore else 'part'}{r}.{'npz' if restore else 'bin'}"
        outs.append(out)
        extra = [str(stream)] if restore else []
        if who == "torch":
            argvs.append([sys.executable, str(HERE), str(r), str(nproc), str(port),
                          str(n_total), mode, codec, str(out), mesh] + extra)
        else:
            argvs.append([sys.executable, str(REF_WORKER), f"127.0.0.1:{port}", str(nproc),
                          str(r), str(n_total), mode, str(out), codec] + extra)
    _launch(argvs)
    return outs


def _stream(outs) -> bytes:
    return b"".join(o.read_bytes() for o in outs)


def _frame_table(blob: bytes):
    from dctz_tpu_torch.parallel import multihost as mh

    n_total, frames = mh._scan_frames(memoryview(blob))
    return n_total, [(n, bs, dpk) for _off, _len, n, bs, dpk in frames]


def _restored(outs):
    parts = [np.load(o) for o in outs]
    return [(int(p["start"]), tuple(p["frames"].tolist()), p["data"]) for p in parts]


def _same_restores(got, want) -> None:
    """Each rank's start and frames equal, its float64 data within 8 eps64
    * max|y| of the reference rank's."""
    from test_torch_f64 import EPS64

    assert len(got) == len(want)
    for (s1, f1, d1), (s2, f2, d2) in zip(got, want):
        assert (s1, f1) == (s2, f2) and d1.shape == d2.shape and d1.dtype == d2.dtype
        if d2.size:
            assert np.abs(d1 - d2).max() <= 8 * EPS64 * np.abs(d2).max()


def _check_write(x, port: bytes, ref: bytes) -> None:
    """The frame tables equal, the frames equal by the float64 rules, and
    both packages' decompress restoring the port's stream within the
    bound."""
    import dctz_tpu
    import dctz_tpu_torch as dz
    from test_torch_f64 import assert_same_container

    assert _frame_table(port) == _frame_table(ref)
    assert_same_container(port, ref)
    for y in (dz.decompress(port, device="cpu"), np.asarray(dctz_tpu.decompress(port))):
        assert y.dtype == np.float64 and y.shape == x.shape
        assert np.abs(y - x).max() <= EB * float(x.max() - x.min())


def test_rank_data_is_the_reference_workers():
    import importlib.util

    spec = importlib.util.spec_from_file_location("_mh_worker", REF_WORKER)
    wmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wmod)
    for n in (7, 64 * 311 + 7):
        assert make_data(n).tobytes() == wmod.make_data(n).tobytes()


def test_init_is_a_noop_for_one_process():
    import torch.distributed as dist

    from dctz_tpu_torch.parallel import multihost as mh

    mh.init()
    assert not dist.is_initialized()
    assert mh.process_count() == 1 and mh.process_index() == 0
    assert mh.host_slice(64 * 100, mesh=["cpu"]) == (0, 64 * 100)


@pytest.mark.parametrize("mode,codec", [("ec", "device"), ("qt", "deflate")])
def test_two_ranks_write_as_the_reference(tmp_path, mode, codec):
    """2 gloo ranks x 2 shards against 2 jax.distributed processes x 2
    devices: the same frame table and frames; the padding on the last
    rank."""
    n_total = 64 * 1200 + 7
    x = make_data(n_total)
    port = _stream(_run(tmp_path, "torch", 2, n_total, mode, codec))
    ref = _stream(_run(tmp_path, "jax", 2, n_total, mode, codec))
    _check_write(x, port, ref)


def test_four_ranks_write_then_two_ranks_restore(tmp_path):
    """4 writer ranks (the last one's slice mostly padding), then a restore
    by 2 ranks, in both packages on the port's stream: each reader decodes
    the two frames of its slice, and its slice equals the reference
    reader's."""
    n_total = 64 * 1700 + 13
    x = make_data(n_total)
    port = _stream(_run(tmp_path, "torch", 4, n_total, "ec", "device"))
    ref = _stream(_run(tmp_path, "jax", 4, n_total, "ec", "device"))
    _check_write(x, port, ref)
    path = tmp_path / "stream4.bin"
    path.write_bytes(port)
    got = _restored(_run(tmp_path, "torch", 2, n_total, "restore", "device", path))
    want = _restored(_run(tmp_path, "jax", 2, n_total, "restore", "device", path))
    _same_restores(got, want)
    assert sorted(len(f) for _s, f, _d in got) == [2, 2]
    full = np.concatenate([d for _s, _f, d in got])[:n_total]
    assert np.abs(full - x).max() <= EB * float(x.max() - x.min())


def test_monolithic_dpk_restore_by_tile_range(tmp_path):
    """ONE monolithic DPK container (the port's, float64) restored by 2
    ranks in each package: each rank decodes only its tile range, with the
    same starts as the reference's, and the slices concatenate to the
    port's single-process decode."""
    import dctz_tpu_torch as dz

    n_total = 64 * 1200 + 7
    x = make_data(n_total)
    cfg = dz.CodecConfig(error_bound=EB, container="v2", ids_codec="device", verify=True,
                         segment_elems=0)
    blob = dz.compress(x, config=cfg, device="cpu")
    path = tmp_path / "mono.bin"
    path.write_bytes(blob)
    got = _restored(_run(tmp_path, "torch", 2, n_total, "restore", "device", path))
    want = _restored(_run(tmp_path, "jax", 2, n_total, "restore", "device", path))
    _same_restores(got, want)
    assert all(f == () for _s, f, _d in got) and got[1][0] > 0
    full = np.concatenate([d for _s, _f, d in got])
    assert np.array_equal(full, dz.decompress(blob, device="cpu"))


def test_single_process_writes_one_frame():
    """One process: compress_multihost is compress_sharded in a DTZS frame
    (the reference's container on the same shard count), and
    decompress_multihost restores the whole array from start 0, of a
    stream and of a monolithic container."""
    import jax

    import dctz_tpu_torch as dz
    from dctz_tpu.config import CodecConfig as JConfig
    from dctz_tpu.parallel import multihost as jmh
    from dctz_tpu_torch.parallel import multihost as mh
    from test_torch_f64 import assert_same_container

    x = np.random.default_rng(0).standard_normal(64 * 200 + 5) * 12
    kw = dict(error_bound=EB, container="v2", ids_codec="deflate")
    blob = mh.compress_multihost(x, x.size, config=dz.CodecConfig(**kw),
                                 mesh=["cpu"] * len(jax.devices()))
    assert_same_container(blob, jmh.compress_multihost(x, x.size, config=JConfig(**kw)))
    res = mh.decompress_multihost(blob, mesh=["cpu"])
    assert res.start == 0 and res.frames == (0,)
    assert np.array_equal(res.data, dz.decompress(blob, device="cpu"))
    mono = dz.compress(x.astype(np.float32), config=dz.CodecConfig(**kw), device="cpu")
    res = mh.decompress_multihost(mono, mesh=["cpu"])
    assert res.start == 0 and res.frames == ()
    assert np.array_equal(res.data, dz.decompress(mono, device="cpu"))


# ---------------------------------------------------------------------------
# the tile-range decode
# ---------------------------------------------------------------------------


def _dpk_container(n: int, codec: str, **kw):
    """The reference's monolithic DPK container (float32; x64 on and no
    fused force: the XLA chain's container of the true length)."""
    import dctz_tpu

    x = (np.sin(np.arange(n, dtype=np.float32) * 0.01) * 20
         + np.random.default_rng(11).standard_normal(n).astype(np.float32) * 0.05)
    cfg = dctz_tpu.CodecConfig(mode="ec", error_bound=EB, container="v2", ids_codec="device",
                               dpk_host_codec=codec, segment_elems=0, **kw)
    return x, dctz_tpu.compress(x, config=cfg)


@pytest.mark.parametrize("n,codec", [((1 << 16) + 777, "none"), (1 << 16, "zstd"),
                                     (1 << 16, "deflate"), (1 << 15, "rans")])
def test_dpk_range_decode_matches_reference(ref_arithmetic, n, codec):
    """_decompress_dpk_range over three tile ranges: each range equal to
    the reference's range, and the ranges concatenating to the port's full
    decode, for every host codec of the packed section and a ragged tail
    tile."""
    from dctz_tpu import api as ja
    from dctz_tpu.core import container as jct
    import dctz_tpu_torch as dz
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import container as ct
    from dctz_tpu_torch.ops import idpack

    x, blob = _dpk_container(n, codec)
    header, streams, qtable, _cb = ct.parse_v2(blob)
    assert header.dpk
    jh, js, jq, _ = jct.parse_v2(blob)
    n_stream, tile_b, cw = api._dpk_meta(header, streams)
    assert (n_stream, tile_b, cw) == tuple(ja._dpk_meta(jh, js))
    t = idpack.tiles_of(-(-n_stream // header.block_size), tile_b)
    cuts = sorted({0, t // 3, 2 * t // 3, t})
    parts = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        got = api._decompress_dpk_range(header, streams, qtable, a, b, device="cpu")
        want = np.asarray(ja._decompress_dpk_range(jh, js, jq, a, b))
        assert got.dtype == want.dtype and np.array_equal(got, want), (a, b)
        parts.append(got)
    assert np.array_equal(np.concatenate(parts), dz.decompress(blob, device="cpu"))


def _chunk_offset(blob: bytes, chunk) -> int:
    base = np.frombuffer(blob, np.uint8)
    return np.frombuffer(chunk, np.uint8).ctypes.data - base.ctypes.data


@pytest.mark.parametrize("codec", ["zstd", "none"])
def test_dpk_range_deferred_crc_is_range_local(monkeypatch, codec):
    """parse_v2(chunk_crcs="defer") + _decompress_dpk_range checks ONLY the
    chunks its tile range touches: a quarter range hashes well under half
    the payload; a corrupt last bulk chunk goes unnoticed by an early
    range, and raises for a range that covers it and for a full parse."""
    import dctz_tpu
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import container as ct
    from dctz_tpu_torch.core import entropy
    from dctz_tpu_torch.ops import idpack

    if codec == "zstd" and not entropy.zstd_available():
        pytest.skip("zstandard is not installed")
    if codec == "none":  # verbatim sections chunk at _VERBATIM_CHUNK
        from dctz_tpu import api as ja

        monkeypatch.setattr(ja, "_VERBATIM_CHUNK", 4096)
    _x, blob = _dpk_container(1 << 18, codec, chunk_bytes=4096)
    header, streams, qtable, _cb = ct.parse_v2(blob, chunk_crcs="defer")
    packed = streams[1]
    assert header.dpk and len(packed) >= 3
    n_stream, tile_b, _cw = api._dpk_meta(header, streams)
    t = idpack.tiles_of(-(-n_stream // header.block_size), tile_b)
    q = max(1, t // 4)

    tally: list[int] = []
    orig = entropy.crc32_many

    def counting(chunks):
        tally.append(sum(len(c) for c in chunks))
        return orig(chunks)

    monkeypatch.setattr(entropy, "crc32_many", counting)
    quarter = api._decompress_dpk_range(header, streams, qtable, 0, q, device="cpu")
    monkeypatch.setattr(entropy, "crc32_many", orig)
    payload = sum(len(c) for sec in streams for c in sec)
    assert sum(tally) < 0.5 * payload, (sum(tally), payload)
    full = np.asarray(dctz_tpu.decompress(blob))
    assert np.array_equal(quarter, full[: quarter.size])

    off = _chunk_offset(blob, packed[-1])
    bad = bytearray(blob)
    bad[off + len(packed[-1]) - 1] ^= 0xFF
    bad = bytes(bad)
    h2, s2, q2, _ = ct.parse_v2(bad, chunk_crcs="defer")
    early = api._decompress_dpk_range(h2, s2, q2, 0, q, device="cpu")
    assert np.array_equal(early, quarter)
    with pytest.raises(ValueError, match="crc mismatch"):
        api._decompress_dpk_range(h2, s2, q2, 0, t, device="cpu")
    with pytest.raises(ValueError, match="crc mismatch"):
        ct.parse_v2(bad)


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parents[1]))
    _rank_main(sys.argv[1:])
