#!/bin/bash
# The evaluation sweeps of eval/run_suites.sh through the PyTorch port
# (dctz_tpu_torch.eval.harness) on its default device, the CUDA card; there
# is no CPU fallback: without a card the harness fails. The same seven
# sweeps in the same order, the JAX engine "jax" named "torch"; each writes
# eval/results_torch_<suffix>.csv beside the reference's
# eval/results_<suffix>.csv, which it never writes. Real dataset files are
# picked up from $DCTZ_DATA_DIR or the first positional argument; otherwise
# the synthetic fallbacks of dctz_tpu_torch/eval/datasets.py run.
#
#   bash eval/run_suites_torch.sh [DATA_DIR]     # from the repo root
set -e
[ -n "$1" ] && DCTZ_DATA_DIR="$1"
DATA=${DCTZ_DATA_DIR:+--data-dir "$DCTZ_DATA_DIR"}
python -m dctz_tpu_torch.eval.harness --suite msst19  --modes ec qt --engines torch native auto $DATA --out eval/results_torch_msst19.csv
python -m dctz_tpu_torch.eval.harness --suite cesm-atm --modes ec qt --engines torch native auto $DATA --out eval/results_torch_cesm.csv
python -m dctz_tpu_torch.eval.harness --suite randgen --modes ec --engines torch native auto $DATA --out eval/results_torch_randgen.csv
python -m dctz_tpu_torch.eval.harness --suite spectral --modes ec qt --engines torch auto $DATA --out eval/results_torch_spectral.csv
python -m dctz_tpu_torch.eval.harness --suite msst19  --modes ec qt --engines sharded $DATA --out eval/results_torch_msst19_sharded.csv
# matched-PSNR rate-distortion curves (the axis Z-Checker plots)
python -m dctz_tpu_torch.eval.harness --suite spectral --psnr-curve $DATA --out eval/results_torch_spectral_psnr_matched.csv
python -m dctz_tpu_torch.eval.harness --suite msst19 --psnr-curve $DATA --out eval/results_torch_msst19_psnr_matched.csv
echo "all sweeps done"
