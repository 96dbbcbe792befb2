"""Multi-rank orchestration over torch.distributed (port of
dctz_tpu/parallel/multihost.py).

parallel/sharding.py runs one process over a mesh of devices; this module
runs several processes, each with a mesh of its own (by default its own
card, cuda:{rank % device_count}), as one global mesh of world_size x
len(mesh) shards. No rank ever holds the global array:

  * every rank calls init() (torch.distributed.init_process_group: an
    explicit backend, NCCL by default, rank and world size, or the standard
    environment variables);
  * each rank passes only its block-aligned slice of the padded array
    (host_slice) to compress_multihost, which runs the sharded encode on
    its mesh with the scalar reductions (sf, mean, tolerance, flags, QT
    table) all-reduced across ranks (sharding.encode_sharded across_ranks);
  * each rank packs ONE v2 container of its slice (global sf and mean,
    local element count) as a DTZS frame and returns those bytes; rank 0's
    start with the stream header, the last rank's end with the end mark.
    Concatenated in rank order the parts are a DTZS stream that one
    process decompress()es, and whose frames any number of ranks restore
    (decompress_multihost: each rank decodes only the frames that overlap
    its slice; a monolithic DPK container by tile range).

NCCL refuses two ranks on one card; ranks that share a card take
backend="gloo", whose all_reduce runs on host tensors: the scalars move to
the host for it, the shards and kernels stay on the card.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import CodecConfig
from ..core import container as ct
from ..core import entropy
from . import sharding as sh


def _dist():
    import torch.distributed as dist

    return dist


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def init(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str = "nccl",
) -> None:
    """torch.distributed.init_process_group with an explicit backend (NCCL
    by default; gloo where ranks share a card). init_method (e.g.
    "tcp://localhost:29500"), world_size and rank, or the standard
    environment variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    A no-op when a process group is already initialised, or when nothing
    names more than one process. NCCL reduces on the current card, so a
    rank of it first makes its own card (local_mesh's) current."""
    dist = _dist()
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if init_method is None and world_size <= 1:
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def local_mesh(mesh=None) -> list[torch.device]:
    """This rank's mesh: `mesh` when given, else its own card,
    cuda:{rank % device_count}."""
    if mesh is not None:
        return sh.make_mesh(mesh)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not count:
        raise RuntimeError("local_mesh: no CUDA device is visible")
    return [torch.device("cuda", process_index() % count)]


def host_slice(
    n_total: int, block_size: int = 64, quantum_blocks: int = 1, mesh=None
) -> tuple[int, int]:
    """[start, stop) of this rank's contiguous block-aligned share of the
    PADDED flat array, over the global shard count world_size x len(mesh)
    (zero-padding beyond n_total is the caller's). The reference's slices
    for the same global count. quantum_blocks: idpack.B_DEFAULT when
    compressing with ids_codec="device", so tiles never cross shards."""
    nproc = process_count()
    n_pad = sh.padded_size(n_total, nproc * len(local_mesh(mesh)), block_size,
                           quantum_blocks)
    per_host = n_pad // nproc
    assert per_host % block_size == 0
    pid = process_index()
    return pid * per_host, (pid + 1) * per_host


def _pack_local_container(
    bin_ids_l: np.ndarray | None,
    dc_l: np.ndarray,
    ac_l: np.ndarray,
    n_local: int,
    src_dtype: np.dtype,
    sf: float,
    mean: float,
    qtable: np.ndarray | None,
    cfg: CodecConfig,
    dpk_parts: tuple | None = None,
    shard_elems: int = 0,
    stream_len: int = 0,
) -> bytes:
    """One rank's slice -> v2 container (global sf and mean, local length);
    DC and AC shuffled and chunk-deflated (dctz_tpu/parallel/multihost.py:
    97-166). dpk_parts: the rank's (width, packed_rows, exc_rows,
    exc_counts, ac_counts) from the per-shard device id coder, whose id
    stream has the rank's padded length stream_len; else bin_ids_l, the
    host-coded ids."""
    from ..api import _dpk_sections, _header, _ids_streams
    from ..core import quantize as qz
    from ..ops import idpack

    header = _header(cfg, n_local, len(ac_l), sf, mean, src_dtype)
    header.shuffle = cfg.shuffle
    dcb, acb = dc_l.tobytes(), np.asarray(ac_l).tobytes()
    if cfg.shuffle:
        dcb = entropy.shuffle_bytes(dcb, dc_l.dtype.itemsize)
        acb = entropy.shuffle_bytes(acb, np.asarray(ac_l).dtype.itemsize)
    dc_ac_z = (
        entropy.chunked_deflate(dcb, cfg.chunk_bytes, cfg.zlib_level),
        entropy.chunked_deflate(acb, cfg.chunk_bytes, cfg.zlib_level),
    )
    if dpk_parts is not None:
        width_l, packed_l, exc_rows_l, exc_counts_l, ac_counts_l = dpk_parts
        streams = _dpk_sections(
            width_l, packed_l, exc_rows_l, exc_counts_l, ac_counts_l,
            idpack.B_DEFAULT, qz.chunk_width(shard_elems, cfg.block_size),
            stream_len, cfg, header,
        ) + dc_ac_z
    else:
        streams = _ids_streams(bin_ids_l.reshape(-1).tobytes(), cfg, header) + dc_ac_z
    return ct.pack_v2(header, streams, qtable if cfg.mode == "qt" else None,
                      cfg.chunk_bytes)


def compress_multihost(
    local,
    n_total: int,
    error_bound: float = 1e-3,
    mode: str = "ec",
    *,
    config: CodecConfig | None = None,
    mesh=None,
) -> bytes:
    """Compress a distributed array; returns THIS RANK's bytes of the
    global DTZS stream (rank 0's include the stream header, every rank with
    real elements appends one frame, the last rank the end mark).
    Concatenated in rank order the parts form a stream that decompress()
    restores in one process.

    `local`: this rank's slice per host_slice(n_total) (numpy; the last
    rank may pass fewer elements, the rest is zero-padded here); mesh: this
    rank's devices (local_mesh). Float64 runs at full width. A single
    process degenerates to compress_sharded on the mesh."""
    import dataclasses

    from .. import stream as dstream
    from ..api import _pull_shards, _resolve_ids_codec, _warn_bound, compress_sharded
    from ..ops import idpack

    cfg = config or CodecConfig(mode=mode, error_bound=error_bound, container="v2")
    if cfg.container != "v2":
        cfg = dataclasses.replace(cfg, container="v2")
    cfg = _resolve_ids_codec(cfg)
    mesh = local_mesh(mesh)
    if process_count() == 1:
        blob = compress_sharded(local, config=cfg, mesh=mesh)
        head = dstream._HDR.pack(dstream.MAGIC, 1, 0, n_total)
        return head + dstream._FRAME.pack(len(blob)) + blob + dstream._FRAME.pack(0)

    dpk = cfg.ids_codec == "device"
    quantum = idpack.B_DEFAULT if dpk else 1
    pid, nproc = process_index(), process_count()
    src_dtype = np.dtype(getattr(local, "dtype", np.float64))
    local = np.asarray(local).reshape(-1)
    lo, hi = host_slice(n_total, cfg.block_size, quantum, mesh)
    share = hi - lo
    if local.shape[0] < share:  # zero-pad the tail rank's slice
        local = np.concatenate([local, np.zeros(share - local.shape[0], local.dtype)])
    if local.shape[0] != share:
        raise ValueError(f"rank {pid} got {local.shape[0]} elements, expected <= "
                         f"{share} (host_slice of {n_total})")
    n_local_real = max(0, min(n_total - lo, share))

    shards, _ = sh.shard_input(local, mesh, cfg.block_size, quantum)
    enc = sh.encode_sharded(shards, n_real=n_total, cfg=cfg, dpk=dpk,
                            shard_offset=pid * len(mesh), across_ranks=True)
    if enc.ok is not None and not bool(enc.ok):
        _warn_bound()
    host, dc_l, ac_l = _pull_shards(enc, dpk)
    qt = enc.qtable.cpu().numpy() if cfg.mode == "qt" else None
    sf_v, mean_v = float(enc.sf), float(enc.mean)

    parts = []
    if pid == 0:
        parts.append(dstream._HDR.pack(dstream.MAGIC, 1, 0, n_total))
    if n_local_real > 0:  # all-padding ranks contribute no frame
        from ..api import _cat_rows

        if dpk:
            dpk_parts = (np.concatenate([h["width"] for h in host]),
                         np.concatenate([h["packed"] for h in host]),
                         _cat_rows([h["exc_rows"] for h in host]),
                         np.concatenate([h["exc_counts"] for h in host]),
                         np.concatenate([h["dpk_ac_counts"] for h in host]))
            ids_l = None
        else:
            dpk_parts = None
            ids_l = np.concatenate([h["bin_ids"] for h in host])
        blob = _pack_local_container(
            ids_l, dc_l, ac_l, n_local_real, src_dtype, sf_v, mean_v, qt, cfg,
            dpk_parts, share // len(mesh), share,
        )
        parts.append(dstream._FRAME.pack(len(blob)))
        parts.append(blob)
    if pid == nproc - 1:
        parts.append(dstream._FRAME.pack(0))
    return b"".join(parts)


# ---------------------------------------------------------------------------
# distributed restore
# ---------------------------------------------------------------------------


class LocalRestore(tuple):
    """(data, start, frames): this rank's reconstructed slice, its global
    element offset, and the indices of the stream frames it decoded."""

    __slots__ = ()

    def __new__(cls, data, start, frames):
        return tuple.__new__(cls, (data, start, frames))

    data = property(lambda self: self[0])
    start = property(lambda self: self[1])
    frames = property(lambda self: self[2])


def _scan_frames(data: memoryview):
    """DTZS layout scan without decoding: (n_total, [(off, len, n_elements,
    block_size, dpk), ...]); each frame is a v2 container whose fixed
    header carries its element count."""
    import struct

    from .. import stream as dstream

    magic, version, _res, n_total = dstream._HDR.unpack_from(data, 0)
    if magic != dstream.MAGIC:
        raise ValueError("not a DCTZ-TPU stream")
    if version != 1:
        raise ValueError(f"unsupported stream version {version}")
    frames = []
    off = dstream._HDR.size
    while True:
        (length,) = dstream._FRAME.unpack_from(data, off)
        off += dstream._FRAME.size
        if length == 0:
            break
        (fmagic, _v, flags, n, _eb, _sf, _mean, _acc, _nb, bs, _r, _cb) = (
            struct.unpack_from(ct._V2_FIXED_FMT, data, off))
        if fmagic != ct.V2_MAGIC:
            raise ValueError("DTZS frame is not a v2 container")
        frames.append((off, length, n, bs, bool(flags & ct._FLAG_DPK)))
        off += length
    return n_total, frames


def decompress_multihost(stream: bytes | memoryview, *, mesh=None) -> LocalRestore:
    """Inverse of compress_multihost: restore THIS RANK's slice of a DTZS
    stream on the first device of its mesh (local_mesh). Each rank scans
    the frame table (headers only), computes its host_slice and decodes
    ONLY the frames that overlap it: its own frames when the reader count
    matches the writer's, shared ones decoded and sliced otherwise. A
    MONOLITHIC container restores too (_decompress_monolithic_local). A
    single process restores the whole array (start 0)."""
    from ..api import decompress
    from ..ops import idpack

    mesh = local_mesh(mesh)
    data = memoryview(stream)
    if bytes(data[:4]) != b"DTZS":
        return _decompress_monolithic_local(data, mesh)
    n_total, frames = _scan_frames(data)
    if not frames:
        return LocalRestore(np.zeros((0,), np.float32), 0, ())

    bs = frames[0][3]
    quantum = idpack.B_DEFAULT if frames[0][4] else 1
    if process_count() == 1:
        lo, hi = 0, n_total
    else:
        lo, hi = host_slice(n_total, bs, quantum, mesh)
    hi = min(hi, n_total)

    pieces: list[np.ndarray] = []
    used: list[int] = []
    span_lo = 0
    for k, (off, length, n_frame, _bs, _dpk) in enumerate(frames):
        span_hi = span_lo + n_frame
        if span_hi > lo and span_lo < hi:
            seg = decompress(bytes(data[off : off + length]), device=mesh[0])
            a = max(lo, span_lo) - span_lo
            b = min(hi, span_hi) - span_lo
            pieces.append(seg[a:b])
            used.append(k)
        span_lo = span_hi
        if span_lo >= hi:
            break
    if not pieces:  # all-padding rank: nothing real in its slice
        return LocalRestore(np.zeros((0,), np.float32), lo, ())
    local = np.concatenate(pieces) if len(pieces) != 1 else pieces[0]
    return LocalRestore(local, lo, tuple(used))


def _decompress_monolithic_local(data: memoryview, mesh) -> LocalRestore:
    """This rank's slice of a MONOLITHIC container. A v2 DPK container
    decodes by tile range (api._decompress_dpk_range): the bulk packed
    section, the DC and AC plane chunks, the crc checks (a deferred parse)
    and all device work cover just this rank's tiles. Other containers
    decode whole on every rank, then slice."""
    from ..api import _decompress_dpk_range, _dpk_meta, decompress
    from ..ops import idpack

    if process_count() == 1:
        return LocalRestore(decompress(data, device=mesh[0]), 0, ())

    header = None
    if ct.detect_format(data) == "v2":
        header, streams, qtable, _cb = ct.parse_v2(data, chunk_crcs="defer")
    if header is not None and header.dpk:
        n_stream, tile_b, cw, meta = _dpk_meta(header, streams, with_bytes=True)
        bs = header.block_size
        n = header.num_elements
        t_total = idpack.tiles_of(-(-n_stream // bs), tile_b)
        lo, hi = host_slice(n, bs, tile_b, mesh)
        te = tile_b * bs
        t0 = min(lo // te, t_total)
        t1 = min(-(-hi // te), t_total)
        if t0 >= t1 or lo >= n:  # all-padding rank
            return LocalRestore(np.zeros((0,), header.dtype), lo, ())
        local = _decompress_dpk_range(header, streams,
                                      qtable if header.mode == "qt" else None,
                                      t0, t1, meta=meta, device=mesh[0])
        a = lo - t0 * te
        b = min(hi, n) - t0 * te
        return LocalRestore(local[a:b], lo, ())

    out = decompress(data, device=mesh[0])
    bs = header.block_size if header is not None else 64
    lo, hi = host_slice(out.size, bs, 1, mesh)
    if lo >= out.size:
        return LocalRestore(np.zeros((0,), out.dtype), lo, ())
    return LocalRestore(out[lo : min(hi, out.size)], lo, ())
