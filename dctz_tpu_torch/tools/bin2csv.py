"""Raw binary -> CSV converter (tools/bin2csv.py / bin2csv.m equivalent).

Usage: python -m dctz_tpu_torch.tools.bin2csv <in.bin> <out.csv> [--dtype f64|f32|u8]

A copy of dctz_tpu.tools.bin2csv (numpy only).
"""

from __future__ import annotations

import argparse

import numpy as np

_DTYPES = {"f64": np.float64, "f32": np.float32, "u8": np.uint8, "i32": np.int32}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bin2csv")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="f64")
    args = p.parse_args(argv)
    data = np.fromfile(args.src, dtype=_DTYPES[args.dtype])
    np.savetxt(args.dst, data, delimiter=",", fmt="%.17g")
    print(f"wrote {data.size} values to {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
