"""Multi-GPU scaling: the shard-local pipeline over a device mesh (port of
dctz_tpu/parallel/sharding.py).

A mesh is a list of torch.device. The flat array is zero-padded to a
multiple of len(mesh) * block_size (times the DPK tile, 256 blocks, with
the device ids) and cut into equal shards, one per mesh entry, so no DCT
block and no DPK tile crosses a shard. A device may appear more than once:
its shards then run on it one after another. The shards never leave their
devices; only scalars cross them:

  - MAX of max|x| (the scaling factor) and SUM of the float32 shard sums
    (the mean);
  - with verify, MAX and MIN over the real elements (the tolerance), and MIN
    of the verify flags;
  - MAX of the overflow flags (one retry at full chunk width, every shard);
  - in QT, MAX of the pass-1 column maxima, slot 0 included (the last
    blocks' DCs, dctz_tpu/core/quantize.py:197-204).

Each reduction runs first across the local shards in shard order, then,
where the caller asks (parallel/multihost.py) and a torch.distributed
process group is initialised, across ranks with all_reduce. NCCL reduces on
the card; gloo on host tensors, to which the scalars move for the
all_reduce alone.

Per shard the port's single-device kernels run. encode_sharded's fused
body (EC, float32, DPK ids, kernels A and B take the shard's chunk width)
is encode_x_fused: kernels A + B. Every other configuration (QT, host-coded
ids, float64, other geometries) takes the chain body: the forward
transform, bins and verify-repair in torch ops, the AC compaction
(qz.repack: kernel H on the card), and for DPK ids idpack.pack_ids (its
exception bytes through kernel H) and ac_chunk_counts. Only the chunked
compaction layout is ported: the container does not record the layout.
decode_sharded (host-coded ids) runs kernel I then kernel D per shard
where their geometry holds, torch ops elsewhere; decode_sharded_dpk runs
the single-device DPK decode (kernels C + D) per shard.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..config import CodecConfig
from ..core import quantize as qz


def make_mesh(devices=None) -> list[torch.device]:
    """The mesh over every visible card, or over the given devices (a
    device may be listed more than once). A CUDA entry without a card
    raises."""
    from ..api import checked_device

    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not count:
            raise RuntimeError("make_mesh: no CUDA device is visible")
        return [torch.device("cuda", i) for i in range(count)]
    mesh = [checked_device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh: empty device list")
    return mesh


def mesh_for(mesh, device) -> list[torch.device]:
    """The mesh an entry point runs on: `mesh` when given; else every
    visible card for device "cuda" with no index, and that device alone
    otherwise ("cuda:1", "cpu")."""
    from ..api import checked_device

    if mesh is not None:
        return make_mesh(mesh)
    device = checked_device(device)
    if device.type == "cuda" and device.index is None:
        return make_mesh()
    return [device]


def padded_size(
    n: int, n_devices: int, block_size: int, quantum_blocks: int = 1
) -> int:
    quantum = n_devices * block_size * quantum_blocks
    return -(-n // quantum) * quantum


def on_device(device: torch.device):
    """The CUDA device context of a shard's work (its kernels launch on the
    current device's stream); nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _split(flat: torch.Tensor, mesh) -> list[torch.Tensor]:
    """Equal slices of flat, each moved to its mesh device (device to
    device; a slice already there is a view)."""
    n_local = flat.shape[0] // len(mesh)
    return [flat[i * n_local : (i + 1) * n_local].to(d) for i, d in enumerate(mesh)]


def shard_input(
    x: np.ndarray, mesh, block_size: int, quantum_blocks: int = 1
):
    """Zero-pad a host array to the mesh quantum and put one slice on each
    mesh device -> (shards, n_pad). quantum_blocks > 1 aligns every shard to
    that many whole blocks (the DPK id coder's tiles)."""
    n = x.shape[0]
    n_pad = padded_size(n, len(mesh), block_size, quantum_blocks)
    if n_pad != n:
        x = np.concatenate([x, np.zeros(n_pad - n, x.dtype)])
    flat = torch.from_numpy(np.require(x, requirements=["C", "W"]))
    return _split(flat, mesh), n_pad


def shard_input_device(
    x: torch.Tensor,
    mesh,
    block_size: int,
    quantum_blocks: int = 1,
    promote_f32: bool = False,
):
    """Device-resident counterpart of shard_input: flatten, promote float64
    to float32 if asked, zero-pad and split, all on the tensor's device,
    then move each slice to its mesh device -> (shards, n_pad). The input
    never visits the host."""
    n = x.numel()
    n_pad = padded_size(n, len(mesh), block_size, quantum_blocks)
    flat = x.reshape(-1)
    if promote_f32 and flat.dtype == torch.float64:
        flat = flat.to(torch.float32)
    if n_pad != n:
        flat = torch.nn.functional.pad(flat, (0, n_pad - n))
    return _split(flat, mesh), n_pad


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

_LOCAL_OPS = {"max": torch.maximum, "min": torch.minimum, "sum": torch.add}


def _ranks() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """t reduced across the ranks of the initialised process group, on the
    device its backend reduces on: the card for NCCL, the host for gloo."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        comm = t if t.device.type == "cuda" else t.to(
            torch.device("cuda", torch.cuda.current_device()))
    else:
        comm = t.cpu()
    comm = comm.clone()
    dist.all_reduce(comm, op=getattr(dist.ReduceOp, op.upper()))
    return comm.to(t.device)


def reduce(values: list[torch.Tensor], op: str, across_ranks: bool) -> torch.Tensor:
    """One value reduced by op ("max", "min" or "sum") across the local
    shards in shard order, on the first shard's device, then across ranks
    when across_ranks and a process group is initialised."""
    acc = values[0]
    for v in values[1:]:
        acc = _LOCAL_OPS[op](acc, v.to(acc.device))
    if across_ranks and _ranks():
        acc = all_reduce(acc, op)
    return acc


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


class Encoded(NamedTuple):
    """encode_sharded's result. shards: per shard, a dict of its device
    outputs: dc, ac_rows, ac_counts; bin_ids (the chain body); with DPK ids
    width, packed, exc_rows, exc_counts, dpk_ac_counts. The scalars are
    tensors on the first shard's device, reduced over every shard (and
    rank)."""

    shards: list
    sf: torch.Tensor
    mean: torch.Tensor
    qtable: torch.Tensor | None
    ok: torch.Tensor | None


def fused_eligible(cfg: CodecConfig, dpk: bool, dtype: torch.dtype,
                   shard_elems: int) -> bool:
    """The fused body's dispatch (dctz_tpu/parallel/sharding.py:157-170):
    EC with DPK ids on float32 shards whose chunk width kernels A and B
    take. QT takes the chain body, as in the reference."""
    from ..ops import dpk_fuse, idpack

    return (dpk and cfg.mode != "qt" and dtype == torch.float32
            and dpk_fuse.encode_eligible(
                idpack.B_DEFAULT, cfg.block_size,
                qz.chunk_width(shard_elems, cfg.block_size), cfg.nbins))


def _valid_counts(n_real: int, n_local: int, n_shards: int, offset: int):
    """Each shard's real elements: clip(n_real - idx * n_local, 0, n_local)
    for its global index idx (dctz_tpu/parallel/sharding.py:200)."""
    return [min(max(n_real - (offset + i) * n_local, 0), n_local)
            for i in range(n_shards)]


def _stats(shards, n_valid, n_real: int, cfg: CodecConfig, across_ranks: bool):
    """(sf, mean, tolerance or None) of the sharded array, on the first
    shard's device; the tolerance over the real elements, in the shards'
    dtype: (max - min) * eb * _SLACK."""
    from ..core.stats import scaling_factor
    from ..ops.repair import _SLACK

    amaxs, sums, vmaxs, vmins = [], [], [], []
    for x, nv in zip(shards, n_valid):
        with on_device(x.device):
            lo, hi = torch.aminmax(x)
            amaxs.append(torch.maximum(torch.abs(lo), torch.abs(hi)))
            sums.append(torch.sum(x))
            if cfg.verify:
                if nv == x.shape[0]:
                    vmins.append(lo)
                    vmaxs.append(hi)
                elif nv:
                    lo_r, hi_r = torch.aminmax(x[:nv])
                    vmins.append(lo_r)
                    vmaxs.append(hi_r)
                else:
                    vmins.append(torch.full((), float("inf"), dtype=x.dtype, device=x.device))
                    vmaxs.append(torch.full((), float("-inf"), dtype=x.dtype,
                                            device=x.device))
    amax = reduce(amaxs, "max", across_ranks)
    total = reduce(sums, "sum", across_ranks)
    mean = total / torch.tensor(float(n_real), dtype=total.dtype, device=total.device)
    sf = scaling_factor(amax, cfg.sf_adj)
    tol = None
    if cfg.verify:
        vmax = reduce(vmaxs, "max", across_ranks)
        vmin = reduce(vmins, "min", across_ranks)
        tol = (vmax - vmin) * qz._c(cfg.error_bound, vmax) * qz._c(_SLACK, vmax)
    return sf, mean, tol


def _flag(values: list[torch.Tensor], op: str, across_ranks: bool) -> torch.Tensor:
    return reduce([v.to(torch.int32) for v in values], op, across_ranks)


def encode_sharded(
    shards: list[torch.Tensor],
    *,
    n_real: int,
    cfg: CodecConfig,
    dpk: bool = False,
    shard_offset: int = 0,
    across_ranks: bool = False,
) -> Encoded:
    """The sharded encode (dctz_tpu/parallel/sharding.py:126-279): shards
    from shard_input / shard_input_device, all of one length (a block
    multiple; with DPK ids a multiple of the 256-block tile), n_real the
    global element count. shard_offset: the global index of shards[0]
    (multihost: rank * local mesh length); across_ranks: reduce the scalars
    across the process group too. The fused body reruns kernels A + B on
    every shard at full chunk width when any shard's exception rows
    overflow (the reference's retry, dctz_tpu/api.py:2174-2184); the chain
    body recompacts the rows that overflow (qz.repack) and recodes the ids
    of every shard at full chunk width when any exception row overflows:
    the same streams."""
    n_local = shards[0].shape[0]
    n_valid = _valid_counts(n_real, n_local, len(shards), shard_offset)
    sf, mean, tol = _stats(shards, n_valid, n_real, cfg, across_ranks)
    if fused_eligible(cfg, dpk, shards[0].dtype, n_local):
        return _encode_fused(shards, n_valid, cfg, sf, mean, tol, across_ranks)
    return _encode_chain(shards, n_valid, cfg, sf, mean, tol, dpk, across_ranks)


def _encode_fused(shards, n_valid, cfg, sf, mean, tol, across_ranks):
    """Per shard dpk_fuse.encode_x_fused (kernels A + B) with the global sf
    and tolerance and the shard's own count of real elements."""
    from .. import api
    from ..ops import dpk_fuse, idpack

    n_local = shards[0].shape[0]
    cw = qz.chunk_width(n_local, cfg.block_size)
    if tol is None:
        tol = torch.zeros((), dtype=torch.float32, device=sf.device)

    def run(cape):
        outs = []
        for x, nv in zip(shards, n_valid if cfg.verify else [n_local] * len(shards)):
            with on_device(x.device):
                outs.append(dpk_fuse.encode_x_fused(
                    x, sf.to(x.device), tol.to(x.device), nv, cfg.error_bound,
                    min(cape, cw), cw, cfg.verify, relaxed=api._relaxed(cfg),
                    brsf=cfg.brsf))
        return outs, bool(_flag([o[7] for o in outs], "max", across_ranks))

    outs, over = run(idpack.CAPE)
    if over:
        outs, _ = run(cw)
    ok = _flag([o[8] for o in outs], "min", across_ranks).bool() if cfg.verify else None
    per = [dict(width=o[0], packed=o[1], exc_rows=o[2], exc_counts=o[3], ac_rows=o[4],
                ac_counts=o[5], dc=o[6], dpk_ac_counts=o[5]) for o in outs]
    return Encoded(per, sf, mean, None, ok)


def _encode_chain(shards, n_valid, cfg, sf, mean, tol, dpk, across_ranks):
    """Per shard the generic chain (dctz_tpu/parallel/sharding.py:62-117,
    :228-267) in the shards' dtype: the forward transform of the whole
    shard (a block multiple), bins over the whole shard, the QT table
    reduced across shards before pass 2, the verify-repair of the shard's
    real elements against the global tolerance, the compaction
    (qz.repack), and for DPK ids pack_ids and ac_chunk_counts over the
    WHOLE shard (masking by the real count would zero real coefficients of
    a last partial block; pure-padding blocks code to nothing anyway)."""
    from .. import api
    from ..ops import idpack, repair

    bs = cfg.block_size
    n_local = shards[0].shape[0]
    coeffs = []
    for x in shards:
        with on_device(x.device):
            coeffs.append(api._forward_padded(x / sf.to(x.device, x.dtype), bs,
                                              cfg.dct_precision))
    colmax = qtable = None
    if cfg.mode == "qt":
        # pass 1: the column maxima over every shard, slot 0 the MAX of the
        # shards' last-block DCs (the decoder never reads it)
        cms = []
        for c in coeffs:
            cm = qz.escape_colmax(c, n_local, cfg)
            cm[0] = c[-1, 0]
            cms.append(cm)
        colmax = reduce(cms, "max", across_ranks)
        qtable = torch.clamp_min(colmax, 1.0)
        qtable[0] = colmax[0]

    per, oks = [], []
    for x, c, nv in zip(shards, coeffs, n_valid):
        dev = x.device
        with on_device(dev):
            qt_d = None if qtable is None else qtable.to(dev)
            ids, dc, vals, _ = qz.quantize(
                c, n_local, cfg, None if colmax is None else colmax.to(dev))
            if cfg.verify:
                ids, ok = repair.verify_repair(x, c, sf.to(dev), ids, dc, n_local, nv,
                                               cfg, tol.to(dev), qt_d)
                oks.append(ok)
                acm = qz.ac_mask(c.shape[0], bs, n_local, dev)
                vals = repair.stored_dense(c, ids, acm, cfg, qt_d)
            q = qz.repack(ids, vals, dc, qt_d, n_local, cfg)
        per.append(dict(bin_ids=q.bin_ids, dc=q.dc, ac_rows=q.ac_buf,
                        ac_counts=q.ac_count))
    del coeffs
    if dpk:
        cw = qz.chunk_width(n_local, bs)

        def code(cape):
            ovf = []
            for s in per:
                with on_device(s["bin_ids"].device):
                    (s["width"], s["packed"], s["exc_rows"], s["exc_counts"],
                     o) = idpack.pack_ids(s["bin_ids"], n_local, idpack.B_DEFAULT, cape)
                ovf.append(o)
            return bool(_flag(ovf, "max", across_ranks))

        if code(idpack.CAPE):
            code(1 << 20)
        for s in per:
            with on_device(s["bin_ids"].device):
                s["dpk_ac_counts"] = idpack.ac_chunk_counts(s["bin_ids"], n_local, cw)
    ok = _flag(oks, "min", across_ranks).bool() if cfg.verify else None
    return Encoded(per, sf, mean, qtable, ok)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _scalars(sf: float, qtable, dtype: torch.dtype, dev: torch.device):
    sf_t = torch.tensor(sf, dtype=dtype, device=dev)
    qt = (None if qtable is None
          else torch.from_numpy(np.array(qtable)).to(device=dev, dtype=dtype))
    return sf_t, qt


def _rows(a: np.ndarray, i: int, k: int) -> torch.Tensor:
    """Rows [i*k, (i+1)*k) of a host array as a tensor."""
    return torch.from_numpy(np.require(a[i * k : (i + 1) * k], requirements=["C", "W"]))


def decode_sharded(
    bin_ids: np.ndarray,
    dc: np.ndarray,
    ac_rows: np.ndarray,
    sf: float,
    qtable,
    *,
    cfg: CodecConfig,
    dtype: torch.dtype,
    mesh,
) -> list[torch.Tensor]:
    """The sharded decode of a host-coded container
    (dctz_tpu/parallel/sharding.py:285-329): bin_ids (n_pad/bs, bs) u8, dc
    (n_pad/bs,), ac_rows (nc, capc) chunk rows of the stored dtype, each cut
    into len(mesh) equal parts along its rows. Per shard on its device: the
    AC rows back at the escapes (qz.expand_ac: kernel I where it takes the
    chunk width) and the dequantization and inverse transform of the whole
    shard (api._dequantize: kernel D for float32 at blocks of 64 and 255
    bins, torch ops in `dtype` elsewhere). qtable selects QT. Returns the
    shards' samples, each on its device."""
    from .. import api

    n_dev = len(mesh)
    rows_b = bin_ids.shape[0] // n_dev
    rows_c = ac_rows.shape[0] // n_dev
    n_local = rows_b * cfg.block_size
    out = []
    for i, dev in enumerate(mesh):
        with on_device(dev):
            ids = _rows(bin_ids, i, rows_b).to(dev)
            dc_i = _rows(dc, i, rows_b).to(dev)
            ac_i = _rows(ac_rows, i, rows_c).to(dev)
            sf_t, qt = _scalars(sf, qtable, dtype, dev)
            acv = qz.expand_ac(ids, ac_i, n_local)
            out.append(api._dequantize(ids, acv, dc_i, n_local, cfg, sf_t, qt))
    return out


def decode_sharded_dpk(
    width: np.ndarray,
    rows: np.ndarray,
    exc_rows: np.ndarray,
    dc: np.ndarray,
    ac_rows: np.ndarray,
    sf: float,
    qtable,
    *,
    tile_b: int,
    cw: int,
    cfg: CodecConfig,
    dtype: torch.dtype,
    mesh,
) -> list[torch.Tensor]:
    """The sharded decode of a DPK container
    (dctz_tpu/parallel/sharding.py:336-405): every input is tile- or
    chunk-major and padded by the caller to a whole-tile multiple of the
    mesh (synthetic zero tiles decode to zero blocks), so each shard takes
    whole tiles and decodes alone: per shard the single-device DPK decode
    (api._decode_device_dpk: kernels C + D where they take the container,
    torch ops elsewhere). Returns the shards' samples, each on its
    device."""
    from .. import api

    n_dev = len(mesh)
    t_l = width.shape[0] // n_dev
    bs = cfg.block_size
    epc = tile_b * bs // cw
    n_local = t_l * tile_b * bs
    out = []
    for i, dev in enumerate(mesh):
        with on_device(dev):
            parts = [_rows(a, i, k).to(dev) for a, k in (
                (width, t_l), (rows, t_l * bs), (exc_rows, t_l * epc),
                (dc, t_l * tile_b), (ac_rows, t_l * epc))]
            sf_t, qt = _scalars(sf, qtable, dtype, dev)
            out.append(api._decode_device_dpk(*parts, n_local, cfg, tile_b, cw, sf_t,
                                              False, qt))
    return out
