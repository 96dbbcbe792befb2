"""Container header inspector (tools/dctz-dump.c:17-56 equivalent).

The port of dctz_tpu.tools.dctz_dump: dump() reads headers only and gives
the same dict; extract() writes the same raw streams, rebuilding a DPK
container's id stream on a device (the card unless device="cpu" or
--device cpu).

Usage: python -m dctz_tpu_torch.tools.dctz_dump [--extract] [--device cuda|cpu]
           <file.z> [...]
"""

from __future__ import annotations

import json
import sys

from . import pop_device


def dump(path: str) -> dict:
    from ..core import container as ct

    blob = open(path, "rb").read()
    if blob[:4] == b"DTZS":
        return _dump_stream(path, blob)
    fmt = ct.detect_format(blob)
    if fmt == "v2":
        hdr, streams, qtable, chunk_bytes = ct.parse_v2(blob)
        chunks = [len(s) for s in streams]
    else:
        hdr, bz, dz, az, qtable = ct.parse_v1(blob)
        chunks = [1, 1, 1]
    return {
        "file": path,
        "format": fmt,
        "filters": {
            "shuffle": hdr.shuffle,
            "ids4": hdr.ids4,
            "rans": hdr.rans,
            "dpk": hdr.dpk,
            "dpkz": hdr.dpkz,
            "dpkr": hdr.dpkr,
            "dpks": hdr.dpks,
            "plc": hdr.plc,
            "zst": hdr.zst,
        },
        "datatype": hdr.dtype.name,
        "num_elements": hdr.num_elements,
        "error_bound": hdr.error_bound,
        "mode": hdr.mode,
        "tot_AC_exact_count": hdr.ac_count,
        "scaling_factor": hdr.scaling_factor,
        "mean": hdr.mean,
        "bindex_sz_compressed": hdr.bindex_nbytes,
        "DC_sz_compressed": hdr.dc_nbytes,
        "AC_exact_sz_compressed": hdr.ac_nbytes,
        "chunks_per_stream": chunks,
        "has_qtable": qtable is not None,
        "total_bytes": len(blob),
    }


def extract(path: str, out_prefix: str | None = None,
            device: str = "cuda") -> list[str]:
    """Write the raw decoded streams next to the container — the artifacts
    the reference dumps unconditionally during compression
    (bin_index.bin / DC.bin / AC_exact.bin, dctz-comp-lib.c:583-595)."""
    from ..core import container as ct
    from ..core import entropy

    blob = open(path, "rb").read()
    if ct.detect_format(blob) == "v2":
        hdr, streams, qtable, _cb = ct.parse_v2(blob)
        if hdr.dpk:
            # device-packed ids: rebuild the device inputs and unpack the
            # raw id stream on `device` (idpack.unpack_ids: torch ops, and
            # kernel I for the exception bytes on the card); the DC and AC
            # sections as stored (a DC delta kept, as the reference's
            # extract keeps it)
            import numpy as np
            import torch

            from ..api import _dpk_host_rebuild, checked_device
            from ..ops import idpack

            device = checked_device(device)
            (
                width, rows, exc_rows, dc, ac, n_stream, tile_b, cw, _acc,
                nblk,
            ) = _dpk_host_rebuild(hdr, streams, float_planes=False)
            bindex = (
                idpack.unpack_ids(
                    *(torch.from_numpy(np.array(a)).to(device)
                      for a in (width, rows, exc_rows)),
                    nblk,
                    hdr.block_size,
                    tile_b,
                    cw,
                )
                .cpu()
                .numpy()
                .tobytes()
            )
        else:
            from ..api import _inflate_v2_streams

            bindex, dc, ac = _inflate_v2_streams(hdr, streams)
    else:
        hdr, bz, dz, az, qtable = ct.parse_v1(blob)
        bindex, dc, ac = entropy.inflate_streams([bz, dz, az])
    prefix = out_prefix or path
    written = []
    for name, data in (
        ("bin_index.bin", bindex),
        ("DC.bin", dc),
        ("AC_exact.bin", ac),
    ):
        p = f"{prefix}.{name}"
        open(p, "wb").write(data)
        written.append(p)
    if qtable is not None:
        p = f"{prefix}.qtable.bin"
        qtable.tofile(p)
        written.append(p)
    return written


def _dump_stream(path: str, blob: bytes) -> dict:
    """DTZS stream summary: header + per-frame container headers."""
    from .. import stream as dstream
    from ..core import container as ct

    magic, version, _res, n_total = dstream._HDR.unpack_from(blob, 0)
    frames = []
    off = dstream._HDR.size
    while True:
        (length,) = dstream._FRAME.unpack_from(blob, off)
        off += dstream._FRAME.size
        if length == 0:
            break
        hdr, _s, _q, _cb = ct.parse_v2(blob[off : off + length])
        frames.append(
            {
                "bytes": length,
                "num_elements": hdr.num_elements,
                "mode": hdr.mode,
                "dpk": hdr.dpk,
                "ratio": round(
                    hdr.num_elements * hdr.dtype.itemsize / length, 4
                ),
            }
        )
        off += length
    return {
        "file": path,
        "format": "dtzs-stream",
        "version": version,
        "total_elements": n_total,
        "frames": frames,
        "total_bytes": len(blob),
    }


def main(argv: list[str] | None = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    do_extract = "--extract" in argv
    if do_extract:
        argv.remove("--extract")
    device = pop_device(argv, "dctz_dump")
    if device is None:
        return 2
    if not argv:
        print(
            "usage: dctz_dump [--extract] [--device cuda|cpu] <file.z> [...]",
            file=sys.stderr,
        )
        return 2
    for path in argv:
        print(json.dumps(dump(path), indent=2))
        if do_extract:
            for p in extract(path, device=device):
                print(f"wrote {p}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
