"""Z-Checker integration config generator (zc-patches/* equivalents, C19).

The reference ships hand-written Z-Checker registration configs so its
binaries can be benchmarked head-to-head against SZ/zfp
(zc-patches/manageCompressor-dctz-{ec,qt}.cfg, errBounds.cfg, varInfo.txt,
zc-ratedistortion.sh). This module generates the same artifacts for the
PyTorch port's CLI so an installed Z-Checker can drive it unmodified. The
output is dctz_tpu.eval.zc_compat's with the package named dctz_tpu_torch:
the compressor registers as dctz_tpu_torch_{ec,qt}, and its command lines
run `-m dctz_tpu_torch.cli` and `-m dctz_tpu_torch.eval.harness`. Z-Checker
passes no --device, so those runs take the CLI's and the harness's default,
the CUDA card.

Usage: python -m dctz_tpu_torch.eval.zc_compat --out zc-configs/
"""

from __future__ import annotations

import argparse
import pathlib
import sys

BOUNDS = ["1E-3", "1E-4", "1E-5"]  # zc-patches/errBounds.cfg:12-18


def compressor_cfg(mode: str, python: str = sys.executable) -> str:
    """manageCompressor config for one mode (exeCommand drives our CLI with
    the reference argv protocol)."""
    name = f"dctz_tpu_torch_{mode}"
    return f"""#ZC compressor registration for {name}
compressorName = {name}
#errBounds swept by the rate-distortion driver
errBounds = {" ".join(BOUNDS)}
#exeCommand: DATA_TYPE ERR_BOUND VAR_NAME FILE_PATH DIMS... CASE_NAME
exeCommand = {python} -m dctz_tpu_torch.cli $DATA_TYPE $ERR_BND $VAR_NAME $FILE_PATH $DIMS $CASE_NAME --mode {mode}
"""


def var_info(datasets) -> str:
    """varInfo.txt: one `name dims...` line per dataset."""
    lines = []
    for ds in datasets:
        dims = " ".join(str(d) for d in ds.dims)
        lines.append(f"{ds.name} {dims}")
    return "\n".join(lines) + "\n"


def ratedistortion_script(modes=("ec", "qt")) -> str:
    """zc-ratedistortion.sh equivalent: sweep error bounds per compressor."""
    runs = "\n".join(
        f'  python -m dctz_tpu_torch.eval.harness --suite "$SUITE" '
        f"--bounds {' '.join(b.replace('E', 'e') for b in BOUNDS)} "
        f"--modes {m} --out results_{m}.csv" for m in modes
    )
    return f"""#!/bin/bash
# Rate-distortion sweep (zc-patches/zc-ratedistortion.sh:40-48 equivalent).
set -e
SUITE=${{1:-msst19}}
{runs}
echo "rate-distortion CSVs written"
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="zc_compat")
    p.add_argument("--out", default="zc-configs")
    args = p.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    from .datasets import MSST19

    for mode in ("ec", "qt"):
        (out / f"manageCompressor-dctz-tpu-{mode}.cfg").write_text(
            compressor_cfg(mode)
        )
    (out / "varInfo.txt").write_text(var_info(MSST19))
    sh = out / "zc-ratedistortion.sh"
    sh.write_text(ratedistortion_script())
    sh.chmod(0o755)
    print(f"wrote Z-Checker configs to {out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
