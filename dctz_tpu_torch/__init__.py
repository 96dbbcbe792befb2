"""dctz_tpu_torch: the PyTorch + CUDA port of DCTZ-TPU.

The JAX package dctz_tpu stays the reference. This package runs the slice its
benchmark measures (float32, EC or QT, v2 container with the device-packed id
stream, verify on or off, monolithic or as a segmented DTZS stream) on an
NVIDIA H100 through hand-written CUDA kernels (ops/dpk_fuse.py,
ops/fused_encode.py, csrc/), and on the CPU through their plain PyTorch
versions. It imports torch and numpy, never jax or triton.

    import numpy as np, dctz_tpu_torch as dz
    cfg = dz.CodecConfig(mode="qt", container="v2", ids_codec="device",
                         verify=True)
    blob = dz.compress(x, config=cfg, device="cuda")  # DTZS from 32Mi on
    y = dz.decompress(blob, device="cuda")

The stream writer and readers are in dz.stream, as in dctz_tpu.stream:
compress_stream(x, out, config=cfg, device=...), decompress_stream(f) (one
segment at a time), decompress_stream_all(f) and MemReader.
"""

from . import stream
from .api import compress, decompress
from .config import CodecConfig
from .core.constants import BLK_SZ, NBINS, VERSION
from .utils.metrics import evaluate

__version__ = VERSION

__all__ = [
    "compress",
    "decompress",
    "stream",
    "CodecConfig",
    "evaluate",
    "BLK_SZ",
    "NBINS",
    "VERSION",
]
