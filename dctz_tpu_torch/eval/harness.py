"""Evaluation harness: dataset x error-bound x mode sweeps.

Covers the roles of tests/test-dctz.sh / test-dctz-f.sh (round-trip sweeps
with CR/PSNR/max-rel-err logging) and zc-patches/zc-ratedistortion.sh (the
Z-Checker rate-distortion driver) — but with machine-checkable output: one
CSV/JSONL row per run instead of tee'd logs.

Head-to-head comparators: Z-Checker's SZ/zfp binaries are not installable in
this environment, so the general-purpose lossless codecs Python ships
(zlib, lzma, bz2) serve as the comparison points the harness records; the
CSV schema matches what zc-ratedistortion.sh collects (compressor, dataset,
eb, CR, PSNR) so real Z-Checker results can be merged in later.

The port of dctz_tpu.eval.harness: the same rows in the same CSV columns.
The JAX engine "jax" is "torch" here (compressor dctz_{mode}_torch), and
every run takes a device, the CUDA card unless "cpu" is given (--device);
"native" and "auto" are kept; "sharded" raises until the multi-GPU API is
ported (ROADMAP item 10).

Usage:
    python -m dctz_tpu_torch.eval.harness --suite msst19 --out eval/results.csv
"""

from __future__ import annotations

import argparse
import bz2
import csv
import json
import lzma
import sys
import time
import zlib


from .datasets import SUITES, Dataset

DEFAULT_BOUNDS = (1e-3, 1e-4, 1e-5)  # tests/test-dctz.sh:15


def run_one(
    ds: Dataset,
    error_bound: float,
    mode: str,
    engine: str = "torch",
    data_dir: str | None = None,
    verify: bool = True,
    device: str = "cuda",
) -> dict:
    """One compression round trip -> metrics row.

    verify defaults ON: the harness grades against the north-star's 100%
    pointwise bound satisfaction (ops/repair.py); the reference's own check
    is shipped disabled (util.c:96-102), so pass --no-verify to reproduce
    its faithful (occasionally violating) behavior.

    compress and decompress return host objects (bytes, a numpy array), so
    each call ends with its result copied off the device: the clocks read
    finished work without a synchronize."""
    from ..config import CodecConfig
    from ..utils.metrics import evaluate

    if engine == "sharded":
        from ..api import _todo

        raise _todo("compress_sharded", "10")
    x = ds.load(data_dir)
    t0 = time.perf_counter()
    if engine == "native":
        from .. import native

        blob = native.compress(x, error_bound, mode, verify=verify)
        t1 = time.perf_counter()
        rec = native.decompress(blob)
    elif engine == "auto":
        # rate="auto": the encoder widens the bin geometry per array until
        # the size turns — the bound stays guaranteed (verify forced on).
        # The rate-distortion row Z-Checker would grade at matched bound.
        from .. import compress, decompress

        cfg = CodecConfig(
            mode=mode, error_bound=error_bound, container="v2",
            rate="auto", verify=True,
        )
        blob = compress(x, config=cfg, device=device)
        t1 = time.perf_counter()
        rec = decompress(blob, device=device)
    else:
        from .. import compress, decompress

        cfg = CodecConfig(mode=mode, error_bound=error_bound, verify=verify)
        blob = compress(x, config=cfg, device=device)
        t1 = time.perf_counter()
        rec = decompress(blob, device=device)
    t2 = time.perf_counter()
    from ..utils.metrics import ssim as _ssim

    m = evaluate(x, rec, error_bound, len(blob))
    return {
        "compressor": f"dctz_{mode}_{engine}",
        "dataset": ds.name,
        "source": ds.source(data_dir),
        "dtype": ds.dtype,
        "n": ds.n,
        "error_bound": error_bound,
        "ratio": round(m["ratio"], 4),
        "psnr_db": round(m["psnr_db"], 3),
        "max_rel_err": m["max_rel_err"],
        "ssim": round(_ssim(x, rec, shape=ds.dims), 5),
        "bound_satisfied": m["bound_satisfied"],
        "verify": verify,
        "compress_mb_s": round(x.nbytes / 1e6 / (t1 - t0), 2),
        "decompress_mb_s": round(x.nbytes / 1e6 / (t2 - t1), 2),
    }


def run_lossless_baseline(ds: Dataset, codec: str, data_dir: str | None = None) -> dict:
    """Lossless comparison point (stand-in for the SZ/zfp head-to-head)."""
    x = ds.load(data_dir)
    raw = x.tobytes()
    t0 = time.perf_counter()
    if codec == "zlib":
        blob = zlib.compress(raw, 6)
    elif codec == "lzma":
        blob = lzma.compress(raw, preset=1)
    else:
        blob = bz2.compress(raw, 5)
    dt = time.perf_counter() - t0
    return {
        "compressor": codec,
        "dataset": ds.name,
        "source": ds.source(data_dir),
        "dtype": ds.dtype,
        "n": ds.n,
        "error_bound": 0.0,
        "ratio": round(len(raw) / len(blob), 4),
        "psnr_db": float("inf"),
        "max_rel_err": 0.0,
        "ssim": 1.0,
        "bound_satisfied": True,
        "verify": False,
        "compress_mb_s": round(len(raw) / 1e6 / dt, 2),
        "decompress_mb_s": float("nan"),
    }


def run_sz_like(ds: Dataset, error_bound: float, data_dir: str | None = None) -> dict:
    """The error-bounded competitor point (eval/sz_like.py): a faithful
    minimal SZ-1.x predictor codec — real (ratio, PSNR) at each bound, the
    comparison zc-ratedistortion.sh runs against the actual SZ binary."""
    from ..utils.metrics import evaluate
    from . import sz_like

    x = ds.load(data_dir)
    t0 = time.perf_counter()
    blob = sz_like.compress(x, error_bound)
    t1 = time.perf_counter()
    rec = sz_like.decompress(blob)
    t2 = time.perf_counter()
    from ..utils.metrics import ssim as _ssim

    m = evaluate(x, rec, error_bound, len(blob))
    return {
        "compressor": "sz_like",
        "dataset": ds.name,
        "source": ds.source(data_dir),
        "dtype": ds.dtype,
        "n": ds.n,
        "error_bound": error_bound,
        "ratio": round(m["ratio"], 4),
        "psnr_db": round(m["psnr_db"], 3),
        "max_rel_err": m["max_rel_err"],
        "ssim": round(_ssim(x, rec, shape=ds.dims), 5),
        "bound_satisfied": m["bound_satisfied"],
        "verify": True,  # bound-guaranteed by construction
        "compress_mb_s": round(x.nbytes / 1e6 / (t1 - t0), 2),
        "decompress_mb_s": round(x.nbytes / 1e6 / (t2 - t1), 2),
    }


PSNR_CURVE_BOUNDS = (3e-3, 1e-3, 3e-4, 1e-4, 3e-5, 1e-5, 3e-6, 1e-6)


def psnr_curve(
    suite: str,
    data_dir: str | None = None,
    progress=print,
    bounds=PSNR_CURVE_BOUNDS,
    device: str = "cuda",
):
    """Rate-distortion curves on the PSNR axis — the comparison Z-Checker
    actually plots (zc-patches/zc-ratedistortion.sh:40-48): for each dataset
    both codecs sweep a dense bound ladder and record (bits/value, PSNR).
    Matched-PSNR ratios come from interpolating these curves; the CSV keeps
    both codecs' raw points so any PSNR target can be read off."""
    rows = []
    for ds in SUITES[suite]:
        for eb in bounds:
            rows.append(run_sz_like(ds, eb, data_dir))
            progress(json.dumps(rows[-1]))
            rows.append(run_one(ds, eb, "ec", "auto", data_dir, True, device))
            progress(json.dumps(rows[-1]))
    for r in rows:
        itembits = 64 if r["dtype"] == "f64" else 32
        r["bits_per_value"] = round(itembits / r["ratio"], 4)
    return rows


def sweep(
    suite: str,
    bounds=DEFAULT_BOUNDS,
    modes=("ec", "qt"),
    engines=("torch",),
    lossless=("zlib",),
    data_dir: str | None = None,
    progress=print,
    verify: bool = True,
    sz_baseline: bool = True,
    device: str = "cuda",
):
    rows = []
    for ds in SUITES[suite]:
        for codec in lossless:
            rows.append(run_lossless_baseline(ds, codec, data_dir))
            progress(json.dumps(rows[-1]))
        for eb in bounds:
            if sz_baseline:
                rows.append(run_sz_like(ds, eb, data_dir))
                progress(json.dumps(rows[-1]))
            for mode in modes:
                for engine in engines:
                    rows.append(
                        run_one(ds, eb, mode, engine, data_dir, verify, device)
                    )
                    progress(json.dumps(rows[-1]))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dctz-eval-torch")
    p.add_argument("--suite", choices=sorted(SUITES), default="msst19")
    p.add_argument("--bounds", type=float, nargs="+", default=list(DEFAULT_BOUNDS))
    p.add_argument("--modes", nargs="+", default=["ec", "qt"])
    p.add_argument(
        "--engines",
        nargs="+",
        default=["torch"],
        choices=["torch", "native", "sharded", "auto"],
    )
    p.add_argument(
        "--psnr-curve",
        action="store_true",
        help="emit matched-PSNR rate-distortion curves (dctz rate=auto vs "
        "sz_like over a dense bound ladder) instead of the bound sweep",
    )
    p.add_argument("--data-dir", default=None)
    p.add_argument("--out", default=None, help="CSV output path")
    p.add_argument(
        "--no-verify",
        action="store_true",
        help="disable the verify-repair pass (reference-faithful behavior)",
    )
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where the dctz rows compress and decompress (default: the CUDA "
        "card; float64 runs at full width on either)",
    )
    args = p.parse_args(argv)

    if args.psnr_curve:
        rows = psnr_curve(args.suite, data_dir=args.data_dir, device=args.device)
    else:
        rows = sweep(
            args.suite,
            args.bounds,
            args.modes,
            args.engines,
            data_dir=args.data_dir,
            verify=not args.no_verify,
            device=args.device,
        )
    if args.out:
        with open(args.out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {len(rows)} rows to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
