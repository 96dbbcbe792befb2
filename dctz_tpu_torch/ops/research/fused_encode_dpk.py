"""The one-pass DPK encode, raw samples to coded DPK streams: kernel L (port
of dctz_tpu/ops/research/fused_encode_dpk.py).

EC at cape = capc = 128, no verify: scale, DCT, bins, widths, packing and
the chunk-row compaction of exception bytes and AC escapes in one launch
(csrc/fused_encode_dpk.cu), so ids and coefficients never leave the SM. The
streams are those of kernel F (ops/fused_encode.dct_quant) followed by
idpack.pack_ids at cape 128 and compaction.compact_chunked of the escapes at
capc 128, byte for byte. Nothing in api calls it.
"""

from __future__ import annotations

import functools

import torch

from ...config import CodecConfig
from ...core import constants as C
from ...core import quantize as qz
from ...core import transform
from .. import compaction as cp
from .. import dpk_fuse, fused_encode, idpack

BS = 64
B = 256  # blocks per DPK tile (idpack.B_DEFAULT)
CW = 512  # compaction chunk width (compaction.CHUNK_W)
NC = B * BS // CW  # 32 chunk rows per tile
CAP = 128  # capc == cape == 128 (the default tiers)

def _fused_encode_dpk_plain(x: torch.Tensor, sf: torch.Tensor, error_bound: float):
    """Kernel L's plain version, on any device: kernel F's plain version,
    idpack.pack_ids' plain version at cape 128, and compact_rows of the AC
    escapes at capc 128."""
    ids, dcac = fused_encode._dct_quant_plain(
        x, sf, CodecConfig(error_bound=error_bound))
    width, packed, exc, exc_counts, _ = idpack._pack_ids_plain(ids, x.shape[0], B, CAP)
    esc = ids == C.ESCAPE
    esc[:, 0] = False
    ac, ac_counts = cp.compact_rows(esc.reshape(-1, CW), dcac.reshape(-1, CW), CAP)
    return width, packed, exc, exc_counts, ac, ac_counts, dcac[:, 0].contiguous()


def fused_encode_dpk(x: torch.Tensor, sf: torch.Tensor, error_bound: float):
    """Kernel L. Replaces the TPU kernel
    dctz_tpu/ops/research/fused_encode_dpk.py:fused_encode_dpk (line 319,
    pallas_call at line 360).

    x: flat float32 (n,), n a multiple of 1024; sf: float32 scalar tensor on
    x's device. Returns (width (T, 64) u8, packed (T*64, 128) u8, exc_rows
    (n/512, 128) u8, exc_counts (n/512,) i32, ac_rows (n/512, 128) f32,
    ac_counts (n/512,) i32, dc (n/64,) f32) with T = ceil(n / 16384): the
    tail tile is zero-padded. Counts are the true, unclipped ones; AC rows
    keep each chunk row's first 128 escapes."""
    return _encode(x, sf, error_bound,
                   functools.partial(dpk_fuse._launch, "fused_encode_dpk"))


def _encode(x: torch.Tensor, sf: torch.Tensor, error_bound: float, launch):
    """fused_encode_dpk with `launch(*args)` as the card's kernel: kernel
    L's C entry point, or its card-only reference's (ops/research/_ref.py),
    bound to its name. CPU tensors take the plain version."""
    n = x.shape[0]
    if x.dim() != 1 or n % 1024:
        raise ValueError(f"x must be flat with a length that is a multiple of "
                         f"1024, got shape {tuple(x.shape)}")
    if not dpk_fuse._on_cuda(x, sf):
        return _fused_encode_dpk_plain(x, sf, error_bound)
    dpk_fuse._check(x, torch.float32, "x")
    x = dpk_fuse._aligned16(x)
    w, rmin, rmax = qz._geometry(CodecConfig(error_bound=error_bound))
    t = -(-n // (B * BS))
    nc, nblk = n // CW, n // BS
    dev = x.device
    width = torch.empty((t, BS), dtype=torch.uint8, device=dev)
    packed = torch.empty((t * BS, 128), dtype=torch.uint8, device=dev)
    exc = torch.empty((t * NC, CAP), dtype=torch.uint8, device=dev)
    ac = torch.empty((t * NC, CAP), dtype=torch.float32, device=dev)
    exc_counts = torch.empty((t * NC,), dtype=torch.int32, device=dev)
    ac_counts = torch.empty((t * NC,), dtype=torch.int32, device=dev)
    dc = torch.empty((t * B,), dtype=torch.float32, device=dev)
    sf32 = sf.reshape(1).to(torch.float32).contiguous()
    basis = transform.dct2_basis(BS, dev)
    launch(x.data_ptr(), basis.data_ptr(), sf32.data_ptr(), n, rmin, rmax, w,
           width.data_ptr(), packed.data_ptr(), exc.data_ptr(), ac.data_ptr(),
           exc_counts.data_ptr(), ac_counts.data_ptr(), dc.data_ptr())
    return (width, packed, exc[:nc], exc_counts[:nc], ac[:nc], ac_counts[:nc],
            dc[:nblk])
