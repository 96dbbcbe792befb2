"""The fused encode front ends (port of dctz_tpu/ops/fused_encode.py).

  E qtable_qmax:    QT pass 1, the quantizer table
  F dct_quant:      scale, DCT and bins of the non-DPK containers (EC)
  G dct_quant_qt:   the same with the escapes renormalized through the
                    qtable (QT pass 2)

QT runs two passes over the input, as the reference does: pass 1 (kernel E)
reduces the per-position maximum |escaped AC coefficient| of the whole array
into the quantizer table, and pass 2 (kernel G, or kernels A + B on the DPK
path) renormalizes the escapes through it. The pipelines put kernel H
(ops/shuffle.py, through core/quantize.repack) behind F and G: the whole
device encode of a v1 or host-coded v2 container without verify.

relaxed=True (CodecConfig.dct_precision "high") launches the RELAXED
instantiations of E, F and G (qtable_qmax_relaxed, dct_quant_relaxed,
dct_quant_qt_relaxed): the analysis is three bfloat16 products on the tensor
cores, as the TPU kernels' relaxed arms compute it (fused_encode.py:_fwd_dot);
their plain versions run transform.block_dct(.., "high").
"""

from __future__ import annotations

import torch

from ..config import CodecConfig
from ..core import constants as C
from ..core import quantize as qz
from ..core import transform
from ..utils import timing
from . import dpk_fuse
from .repair import _SLACK

BS = dpk_fuse.BS


def _f32(v: float, device) -> torch.Tensor:
    return timing.scalar(v, torch.float32, torch.device(device))


def tolerance(x: torch.Tensor, n_true: int, error_bound: float) -> torch.Tensor:
    """The verify tolerance: (max - min over the n_true real samples of the
    zero-padded x) * eb * _SLACK, a scalar of x's dtype on x's device
    (dctz_tpu/ops/repair.py:113-126)."""
    xv = x[:n_true]
    return (torch.max(xv) - torch.min(xv)) * qz._c(error_bound, x) * qz._c(
        _SLACK, x)


def _qtable_qmax_plain(x: torch.Tensor, sf: torch.Tensor, cfg: CodecConfig,
                       relaxed: bool = False):
    """Kernel E's plain version: the per-position max |coefficient| over
    the out-of-range AC positions of DCT(x / sf), unclamped; slot 0 is 0."""
    _, rmin, rmax = qz._geometry(cfg)
    coef = transform.block_dct((x / sf).reshape(-1, BS),
                               dpk_fuse._precision(relaxed))
    dev = x.device
    escape = ~((coef >= _f32(rmin, dev)) & (coef <= _f32(rmax, dev)))
    escape[:, 0] = False
    mag = torch.where(escape, torch.abs(coef), torch.zeros_like(coef))
    return mag.amax(dim=0)


def qtable_qmax(x: torch.Tensor, sf: torch.Tensor, error_bound: float, *,
                relaxed: bool = False, brsf: float = 1.0) -> torch.Tensor:
    """Kernel E (csrc/qtable_qmax.cu). Replaces the TPU kernel
    dctz_tpu/ops/fused_encode.py:_qtable_pass (line 203) behind qtable_qmax
    (line 229): QT pass 1 alone, the per-position max |escaped AC
    coefficient| of this array, clamped to >= 1.0 (the clamp is glue, as in
    the JAX package). Slot 0 carries no meaning here (1.0): the caller
    patches it with the last real block's DC, the reference quirk. The
    segmented writer max-reduces these across segments (max is
    associative, so that equals the whole-array pass).

    x: flat float32 (n_pad,), n_pad a multiple of 1024 (zero padding adds
    nothing: zero blocks have no escapes); sf: float32 scalar tensor on x's
    device; relaxed: the relaxed analysis (instantiation
    qtable_qmax_relaxed); brsf: the bin geometry, whose range decides what
    escapes. Returns the (64,) float32 qtable on x's device."""
    cfg = CodecConfig(mode="qt", error_bound=error_bound, brsf=brsf)
    n_pad = x.shape[0]
    if not dpk_fuse._on_cuda(x, sf):
        qmax = _qtable_qmax_plain(x, sf, cfg, relaxed)
    else:
        dpk_fuse._check(x, torch.float32, "x")
        if x.dim() != 1 or n_pad % 1024:
            raise ValueError(f"x must be flat with a length that is a "
                             f"multiple of 1024, got shape {tuple(x.shape)}")
        x = dpk_fuse._aligned16(x)
        _, rmin, rmax = qz._geometry(cfg)
        bits = torch.zeros((BS,), dtype=torch.int32, device=x.device)
        sf32 = sf.reshape(1).to(torch.float32).contiguous()
        basis = transform.dct2_basis(BS, x.device)
        dpk_fuse._launch("qtable_qmax" + dpk_fuse._arm(relaxed), x.data_ptr(),
                         basis.data_ptr(),
                         sf32.data_ptr(), n_pad, rmin, rmax, bits.data_ptr())
        qmax = bits.view(torch.float32)
    return torch.clamp_min(qmax, 1.0)


def _dct_quant_plain(x: torch.Tensor, sf: torch.Tensor, cfg: CodecConfig,
                     qtable: torch.Tensor | None = None, relaxed: bool = False):
    """Kernels F and G's plain version: transform.block_dct composed with
    the fused kernels' contract (see dct_quant)."""
    _, rmin, rmax = qz._geometry(cfg)
    coef = transform.block_dct((x / sf).reshape(-1, BS),
                               dpk_fuse._precision(relaxed))
    nblk = coef.shape[0]
    if qtable is None:
        ids = qz.encode_ids(coef, nblk * BS, cfg)
        stored = coef
    else:
        # the TPU kernel's side, coef > rmax (qz.qt_renorm picks it by sign:
        # the same value wherever coef is out of range, the only place used)
        dev = x.device
        side = torch.where(coef > _f32(rmax, dev), _f32(rmax, dev), _f32(rmin, dev))
        norm = ((coef / qtable[None, :]) * _f32(cfg.error_bound, dev)) * _f32(
            cfg.qt_factor, dev) + side
        ids = qz.encode_ids_qt(coef, nblk * BS, cfg, qtable)
        stored = norm
    esc = ids == C.ESCAPE
    esc[:, 0] = False
    dcac = torch.where(esc, stored, torch.zeros_like(coef))
    dcac[:, 0] = coef[:, 0]
    return ids.to(torch.uint8), dcac


def dct_quant(x: torch.Tensor, sf: torch.Tensor, error_bound: float,
              qtable: torch.Tensor | None = None, *, relaxed: bool = False):
    """Kernel F (qtable None) or G (csrc/dct_quant.cu). F replaces the TPU
    kernel dctz_tpu/ops/fused_encode.py:fused_encode_ec (line 363), G the
    pass-2 kernel of fused_encode_qt (line 294).

    x: flat float32 (n_pad,), n_pad a multiple of 1024, zero-padded; sf:
    float32 scalar tensor on x's device; qtable: the (64,) quantizer table
    (kernel E's; slot 0 is not read); relaxed: the relaxed analysis
    (instantiations dct_quant_relaxed, dct_quant_qt_relaxed). Returns (ids
    u8 (n_pad/64, 64):
    ESCAPE at DC and at what stays out of range, padding binned like data;
    dcac f32 (n_pad/64, 64): the DC at column 0, the stored value at AC
    escapes, 0 elsewhere)."""
    cfg = CodecConfig(mode="ec" if qtable is None else "qt",
                      error_bound=error_bound)
    args = (x, sf) + (() if qtable is None else (qtable,))
    if not dpk_fuse._on_cuda(*args):
        return _dct_quant_plain(x, sf, cfg, qtable, relaxed)
    dpk_fuse._check(x, torch.float32, "x")
    n_pad = x.shape[0]
    if x.dim() != 1 or n_pad % 1024:
        raise ValueError(f"x must be flat with a length that is a multiple "
                         f"of 1024, got shape {tuple(x.shape)}")
    x = dpk_fuse._aligned16(x)
    w, rmin, rmax = qz._geometry(cfg)
    ids = torch.empty((n_pad // BS, BS), dtype=torch.uint8, device=x.device)
    dcac = torch.empty((n_pad // BS, BS), dtype=torch.float32, device=x.device)
    sf32 = sf.reshape(1).to(torch.float32).contiguous()
    basis = transform.dct2_basis(BS, x.device)
    arm = dpk_fuse._arm(relaxed)
    if qtable is None:
        dpk_fuse._launch("dct_quant" + arm, x.data_ptr(), basis.data_ptr(),
                         sf32.data_ptr(), n_pad, rmin, rmax, w,
                         ids.data_ptr(), dcac.data_ptr())
    else:
        q32 = dpk_fuse._qtable32(qtable)
        dpk_fuse._launch("dct_quant_qt" + arm, x.data_ptr(), basis.data_ptr(),
                         sf32.data_ptr(), q32.data_ptr(),
                         float(cfg.error_bound), float(cfg.qt_factor), n_pad,
                         rmin, rmax, w, ids.data_ptr(), dcac.data_ptr())
    return ids, dcac


def fused_encode_ec(x: torch.Tensor, sf: torch.Tensor, error_bound: float, *,
                    relaxed: bool = False):
    """Kernel F: (ids (nblk, 64) u8, dcac (nblk, 64) f32), the contract of
    dctz_tpu's fused_encode_ec (relaxed: its dct_precision="high")."""
    return dct_quant(x, sf, error_bound, relaxed=relaxed)


def fused_encode_qt(x: torch.Tensor, sf: torch.Tensor, error_bound: float, *,
                    relaxed: bool = False):
    """Kernel E, then kernel G with its qtable: (ids, dcac, qtable), the
    contract of dctz_tpu's fused_encode_qt (the qtable's slot 0 as E leaves
    it; the pipeline patches it; relaxed: its dct_precision="high")."""
    qtable = qtable_qmax(x, sf, error_bound, relaxed=relaxed)
    return dct_quant(x, sf, error_bound, qtable, relaxed=relaxed) + (qtable,)


def _compact(ids, dcac, error_bound: float, qtable=None) -> qz.Quantized:
    return qz.repack(ids, dcac, dcac[:, 0], qtable, ids.shape[0] * BS,
                     CodecConfig(error_bound=error_bound))


def fused_encode_pipeline(x: torch.Tensor, sf: torch.Tensor, error_bound: float,
                          *, relaxed: bool = False) -> qz.Quantized:
    """Kernel F, then kernel H over the AC escapes: the whole EC device
    encode of a v1 or host-coded v2 container without verify. The fields of
    the returned Quantized are those of
    dctz_tpu.ops.fused_encode.fused_encode_pipeline (ids, dc, ac_chunks
    (nc, capc), counts (nc,), then qtable None and the overflow flag),
    except that an overflow of the default capacity is already recompacted
    at full chunk width (H alone is rerun; `overflowed` says it was)."""
    ids, dcac = fused_encode_ec(x, sf, error_bound, relaxed=relaxed)
    return _compact(ids, dcac, error_bound)


def fused_encode_pipeline_qt(x: torch.Tensor, sf: torch.Tensor,
                             error_bound: float, *,
                             relaxed: bool = False) -> qz.Quantized:
    """Kernels E and G, then H: the QT twin of fused_encode_pipeline, with
    the (64,) qtable whose slot 0 holds the last block's DC, as the JAX
    pipeline sets it (the container stores the last REAL block's instead:
    patch_slot0)."""
    ids, dcac, qtable = fused_encode_qt(x, sf, error_bound, relaxed=relaxed)
    qtable = qtable.clone()
    qtable[0] = dcac[-1, 0]
    return _compact(ids, dcac, error_bound, qtable)


def patch_slot0(qtable: torch.Tensor, dc: torch.Tensor, n_true: int):
    """A copy of qtable whose slot 0 holds the DC of the last REAL block
    (the reference quirk, dctz_tpu/api.py:493-499; zero padding blocks do
    not count). The decoder never reads slot 0."""
    out = qtable.clone()
    out[0] = dc[-(-n_true // BS) - 1]
    return out


def fused_encode_pipeline_dpk_qt_v2(x: torch.Tensor, sf: torch.Tensor,
                                    error_bound: float, cape: int,
                                    n_true: int, verify: bool, *,
                                    relaxed: bool = False):
    """The reference's QT pipeline, kept for parity with it (api and
    stream run the same steps through stream._encode_segment_dpk): kernel
    E reduces the qtable (pass 1), then kernels A + B renormalize, verify
    and pack with it (pass 2). x is the zero-padded flat float32 input.
    Returns (width, packed, exc_rows, exc_counts, ac_rows,
    ac_counts, dc, overflow, ok, qtable), the qtable's slot 0 already
    patched with the last real block's DC."""
    cw = qz.chunk_width(x.shape[0], C.BLK_SZ)
    qtable = qtable_qmax(x, sf, error_bound, relaxed=relaxed)
    tol = tolerance(x, n_true, error_bound)
    out = dpk_fuse.encode_x_fused(
        x, sf, tol, n_true, error_bound, min(cape, cw), cw, verify, qtable,
        relaxed=relaxed,
    )
    return out + (patch_slot0(qtable, out[6], n_true),)
