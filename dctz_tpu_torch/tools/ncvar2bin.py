"""NetCDF variable -> raw binary extractor (tools/ncvar2bin.m equivalent).

The reference uses a Matlab/Octave helper to pull one variable out of a
NetCDF file into the raw .bin layout its drivers read (tools/ncvar2bin.m).
netCDF4 is not a baked-in dependency, so this degrades gracefully: it tries
netCDF4, then scipy.io.netcdf_file (classic NetCDF-3 only).

Usage: python -m dctz_tpu_torch.tools.ncvar2bin <file.nc> <var> <out.bin>
           [--dtype f64|f32]

A copy of dctz_tpu.tools.ncvar2bin (numpy only).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def read_var(path: str, var: str) -> np.ndarray:
    try:
        import netCDF4  # type: ignore

        with netCDF4.Dataset(path) as ds:
            return np.asarray(ds.variables[var][:])
    except ImportError:
        pass
    try:
        from scipy.io import netcdf_file

        with netcdf_file(path, "r", mmap=False) as ds:
            return np.asarray(ds.variables[var].data)
    except Exception as e:  # noqa: BLE001
        raise RuntimeError(
            "could not read NetCDF file: install netCDF4, or use a classic "
            f"NetCDF-3 file for the scipy fallback ({e})"
        ) from e


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ncvar2bin")
    p.add_argument("src")
    p.add_argument("var")
    p.add_argument("out")
    p.add_argument("--dtype", choices=["f64", "f32"], default="f64")
    args = p.parse_args(argv)
    try:
        data = read_var(args.src, args.var)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    dtype = np.float64 if args.dtype == "f64" else np.float32
    data.astype(dtype).reshape(-1).tofile(args.out)
    print(f"wrote {data.size} {args.dtype} elements to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
