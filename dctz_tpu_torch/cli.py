"""Command-line driver with the reference argv protocol.

Reference: dctz-test.c (built four ways: dctz-{ec,qt}-test and the
Z-Checker variants — Makefile:12-24). Protocol (dctz-test.c:42-47):

    dctz-tpu-torch -d|-f <err_bound> <var_name> <srcFilePath> <dims...> [solName]

One driver replaces all four binaries: mode is `--mode ec|qt` (default ec),
and quality metrics that Z-Checker would compute externally are printed as a
JSON line with --json. Outputs match the reference's:
  <src>.{ec|qt}.<eb>.z    compressed container      (dctz-test.c:222-237)
  <src>.{ec|qt}.<eb>.z.r  reconstructed raw binary  (dctz-test.c:240-267)
and the stdout lines `total number of elements`, `outsize`, `Max relative
error`, `CR = ..., PSNR = ...` (dctz-test.c:94,184,277; util.c:95).

The port of dctz_tpu.cli: the same protocol, options, files and lines,
plus --device (the CUDA card unless "cpu" is given). Float64 (-d) runs at
full width, as dctz_tpu does with x64 on. --native runs
dctz_tpu_torch.native (the C++ codec); --sharded raises until the
multi-GPU API is ported (ROADMAP item 10).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dctz-tpu-torch",
        description="error-bounded lossy compressor (DCTZ rebuild), PyTorch "
        "and CUDA",
    )
    # kept as a string: output files embed the literal argv token, like the
    # reference's sprintf("%s.qt.%s.z", path, argv[2]) (dctz-test.c:100)
    p.add_argument("error_bound", type=str)
    p.add_argument("var_name")
    p.add_argument("src")
    p.add_argument(
        "dims",
        nargs="+",
        help="dimension sizes (1-4D; data is treated as flat 1-D) and an "
        "optional trailing solName label",
    )
    p.add_argument("--mode", choices=["ec", "qt"], default="ec")
    p.add_argument(
        "--container",
        choices=["v1", "v2"],
        default="v1",
        help="v1 = reference-compatible format; v2 = chunked format",
    )
    p.add_argument(
        "--ids-codec",
        choices=["auto", "deflate", "rans", "device"],
        default="auto",
        help="bin-index stream coder (v2 only): device = DPK, coded on the "
        "device",
    )
    p.add_argument(
        "--dpk-host-codec",
        choices=["none", "deflate", "rans", "zstd"],
        default="none",
        help="host second stage over the device-packed id section "
        "(--ids-codec device only); zstd = chunk-parallel zstd-1 ratio mode",
    )
    p.add_argument(
        "--host-codec",
        choices=["auto", "zlib"],
        default="auto",
        help="v2 side-section/PLC entropy backend (auto = zstd when available)",
    )
    p.add_argument(
        "--native",
        action="store_true",
        help="use the C++ CPU reference codec instead of the PyTorch pipeline",
    )
    p.add_argument(
        "--sharded",
        action="store_true",
        help="shard over the devices (not ported yet: ROADMAP item 10)",
    )
    p.add_argument(
        "--segment-elems",
        type=lambda s: s if s == "auto" else int(s),
        default="auto",
        help="pipeline compress through DTZS segments of this many elements "
        "(device/host overlap; decompress auto-detects). Default 'auto' "
        "pipelines large v2 EC arrays; 0 forces monolithic",
    )
    p.add_argument(
        "--verify",
        action="store_true",
        help="run the verify-repair pass: the pointwise bound is GUARANTEED "
        "(the reference ships its own check disabled, util.c:96-102)",
    )
    p.add_argument("--json", action="store_true", help="emit a metrics JSON line")
    p.add_argument(
        "--no-write", action="store_true", help="skip writing .z / .z.r files"
    )
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where compress and decompress run (default: the CUDA card)",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    # The dtype selector is a POSITIONAL "-d"/"-f" in the reference protocol
    # (dctz-test.c:121-128), which argparse would treat as an option.
    if not argv or argv[0] not in ("-d", "-f"):
        print(
            "Test case: dctz-tpu-torch -d|-f [err bound] [var name] "
            "[srcFilePath] [dimension sizes...] [solName]",
            file=sys.stderr,
        )
        return 2
    dtype_flag = argv.pop(0)
    args = build_parser().parse_args(argv)
    args.dtype_flag = dtype_flag

    dims: list[int] = []
    sol_name = None
    for d in args.dims:
        try:
            dims.append(int(d))
        except ValueError:
            sol_name = d  # trailing solName (Z-Checker style)
    if not dims:
        print("no dimensions given", file=sys.stderr)
        return 2
    n = int(np.prod(dims))
    print(f"total number of elements = {n}")

    dtype = np.float64 if args.dtype_flag == "-d" else np.float32
    src = pathlib.Path(args.src)
    data = np.fromfile(src, dtype=dtype, count=n)
    if data.size != n:
        print("Error reading file", file=sys.stderr)
        return 1

    eb = float(args.error_bound)
    out_path = src.with_name(f"{src.name}.{args.mode}.{args.error_bound}.z")

    # compress and decompress take and return host objects (a numpy array,
    # bytes), so each timed call ends with its result copied off the card:
    # the clocks read finished work without a synchronize
    t0 = time.perf_counter()
    if args.native:
        from . import native

        blob = native.compress(data, eb, args.mode)
    elif args.sharded:
        from .api import _todo

        raise _todo("compress_sharded", "10")
    else:
        from . import compress
        from .config import CodecConfig

        cfg = CodecConfig(
            mode=args.mode,
            error_bound=eb,
            container=args.container,
            ids_codec=args.ids_codec,
            dpk_host_codec=args.dpk_host_codec,
            host_codec=args.host_codec,
            segment_elems=args.segment_elems,
            verify=args.verify,
        )
        blob = compress(data, config=cfg, device=args.device)
    t_comp = time.perf_counter() - t0

    print(
        f"oriFilePath = {src}, outputFilePath = {out_path}, datatype = "
        f"{'double' if dtype == np.float64 else 'float'}, error = "
        f"{args.error_bound}, dims = {dims}"
    )
    print(f"outsize = {len(blob)}")
    if not args.no_write:
        out_path.write_bytes(blob)

    t0 = time.perf_counter()
    if args.native:
        from . import native

        rec = native.decompress(blob)
    else:
        from . import decompress

        rec = decompress(blob, device=args.device)
    t_decomp = time.perf_counter() - t0
    if not args.no_write:
        rec.astype(dtype).tofile(out_path.with_suffix(out_path.suffix + ".r"))

    from .utils.metrics import evaluate

    m = evaluate(data, rec, eb, len(blob))
    print(f"Max relative error = {m['max_rel_err']:.6f}")
    print(f"CR = {m['ratio']:.2f}, PSNR = {m['psnr_db']:.2f}")
    if args.json:
        m.update(
            var_name=args.var_name,
            sol_name=sol_name,
            mode=args.mode,
            compress_s=t_comp,
            decompress_s=t_decomp,
            mb_per_s_compress=data.nbytes / 1e6 / t_comp,
            mb_per_s_decompress=data.nbytes / 1e6 / t_decomp,
        )
        print(json.dumps(m))
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
