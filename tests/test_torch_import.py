"""The port imports without jax, triton, a GPU or nvcc, and never runs a
CUDA request on the CPU."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


@pytest.mark.parametrize("mod", [
    "dctz_tpu_torch", "dctz_tpu_torch.api", "dctz_tpu_torch.cli",
    "dctz_tpu_torch.eval.harness", "dctz_tpu_torch.eval.datasets",
    "dctz_tpu_torch.eval.sz_like", "dctz_tpu_torch.eval.zc_compat",
    "dctz_tpu_torch.tools.rand_gen", "dctz_tpu_torch.tools.dct_test",
    "dctz_tpu_torch.tools.dctz_dump", "dctz_tpu_torch.tools.ncvar2bin",
    "dctz_tpu_torch.tools.bin2csv", "dctz_tpu_torch.parallel",
    "dctz_tpu_torch.parallel.sharding", "dctz_tpu_torch.parallel.multihost",
])
def test_import_loads_neither_jax_nor_triton(mod):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({mod!r})\n"
        "import dctz_tpu_torch.ops.dpk_fuse, dctz_tpu_torch.kernels.build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'dctz_tpu')]\n"
        "print(repr(bad))\n"
        "assert not bad, bad\n"
    )
    env_path = {"PATH": "/usr/bin:/bin", "PYTHONPATH": "."}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env_path,
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr


def test_import_builds_nothing():
    from dctz_tpu_torch.kernels import build

    assert build._lib is None  # the library loads only at a kernel launch


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only behaviour")
    import dctz_tpu_torch as dz

    cfg = dz.CodecConfig(container="v2", ids_codec="device", segment_elems=0)
    x = np.ones(4096, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        dz.compress(x, config=cfg)  # device defaults to "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        dz.decompress(dz.compress(x, config=cfg, device="cpu"))


def test_kernel_wrappers_refuse_mixed_devices():
    from dctz_tpu_torch.ops import dpk_fuse

    with pytest.raises(ValueError, match="devices"):
        dpk_fuse._on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))
