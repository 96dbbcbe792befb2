"""The benchmark of dctz_tpu_torch (the PyTorch and CUDA port): cells of a
deployment and a traffic mix, run one at a time by benchmark/run.py; see
benchmark/README.md."""
