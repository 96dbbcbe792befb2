"""dctz_tpu_torch: the PyTorch + CUDA port of DCTZ-TPU.

The JAX package dctz_tpu stays the reference. This package runs float32
and float64 input (float64 at full width, as the reference with x64 on),
EC or QT, verify on or off, in the v1 container (the reference's own
format and the default), in v2 with the device-packed id stream (monolithic
or as a segmented DTZS stream) and in host-coded v2 (ids_codec "deflate" or
"rans"), on an NVIDIA H100 through hand-written CUDA kernels
(ops/dpk_fuse.py, ops/fused_encode.py, ops/shuffle.py, csrc/), and on the
CPU through their plain PyTorch versions. It imports torch and numpy, never
jax or triton.

    import numpy as np, dctz_tpu_torch as dz
    blob = dz.compress(x, 1e-3, "ec", device="cuda")  # a v1 container
    cfg = dz.CodecConfig(mode="qt", container="v2", verify=True)
    blob = dz.compress(x, config=cfg, device="cuda")  # DPK; DTZS from 32Mi on
    y = dz.decompress(blob, device="cuda")

compress_sharded / decompress_sharded run the same kernels once per shard of
a device mesh (parallel/sharding.py; mesh=["cuda:0", "cuda:1"], or every
visible card by default), and parallel/multihost.py writes and restores one
DTZS stream from several torch.distributed ranks.

The stream writer and readers are in dz.stream, as in dctz_tpu.stream:
compress_stream(x, out, config=cfg, device=...), decompress_stream(f) (one
segment at a time), decompress_stream_all(f) and MemReader.
"""

from . import stream
from .api import compress, compress_sharded, decompress, decompress_sharded
from .config import CodecConfig
from .core.constants import BLK_SZ, NBINS, VERSION
from .utils.metrics import evaluate

__version__ = VERSION

__all__ = [
    "compress",
    "decompress",
    "compress_sharded",
    "decompress_sharded",
    "stream",
    "CodecConfig",
    "evaluate",
    "BLK_SZ",
    "NBINS",
    "VERSION",
]
