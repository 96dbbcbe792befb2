"""dctz_tpu_torch: the PyTorch + CUDA port of DCTZ-TPU.

The JAX package dctz_tpu stays the reference. This package runs the slice its
benchmark measures (float32, EC, v2 container with the device-packed id
stream, verify on or off) on an NVIDIA H100 through four hand-written CUDA
kernels (ops/dpk_fuse.py, csrc/), and on the CPU through their plain PyTorch
versions. It imports torch and numpy, never jax or triton.

    import numpy as np, dctz_tpu_torch as dz
    cfg = dz.CodecConfig(container="v2", ids_codec="device", verify=True,
                         segment_elems=0)
    blob = dz.compress(x, config=cfg, device="cuda")
    y = dz.decompress(blob, device="cuda")
"""

from .api import compress, decompress
from .config import CodecConfig
from .core.constants import BLK_SZ, NBINS, VERSION
from .utils.metrics import evaluate

__version__ = VERSION

__all__ = [
    "compress",
    "decompress",
    "CodecConfig",
    "evaluate",
    "BLK_SZ",
    "NBINS",
    "VERSION",
]
