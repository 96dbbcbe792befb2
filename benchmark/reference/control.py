"""The control of the correctness check: the reference codec put in the
program's place and computed one precision below the configuration's
float32, in bfloat16 (the forward transform's products, then the inverse
transform's), the step a later change might be tempted by. It need not
write a container: it yields what the check compares (the stored
coefficients and the decoded samples), and check.py's arithmetic reads it.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from . import check, codec


def _bf16_product(a: np.ndarray, b: np.ndarray, device) -> np.ndarray:
    ta = torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)
    tb = torch.from_numpy(b).to(device=device, dtype=torch.bfloat16)
    return (ta @ tb).to(torch.float64).cpu().numpy()


def frame(x_seg: np.ndarray, sf: float, config: dict, device) -> tuple:
    """(stored coefficients float64, binned mask, decoded samples) of one
    frame encoded and decoded in bfloat16."""
    cc = config["codec"]
    eb, bs = float(cc["error_bound"]), codec.BLK_SZ
    w, rmin, rmax = codec.geometry(eb)
    nblk = -(-x_seg.size // bs)
    xs = np.zeros(nblk * bs, np.float64)
    xs[:x_seg.size] = x_seg / sf
    basis = codec.dct_basis(bs)
    c16 = _bf16_product(xs.reshape(nblk, bs), basis.T, device)
    inr = (c16 >= rmin) & (c16 <= rmax)
    inr[:, 0] = False
    coef = np.where(inr, codec.centers(codec.zigzag(c16, w, rmin), w), c16)
    if cc["mode"] == "qt":
        out_ac = ~inr
        out_ac[:, 0] = False
        q = np.maximum(np.where(out_ac, np.abs(c16), 0.0).max(axis=0), 1.0)
        side = np.where(c16 > 0, rmax, rmin)
        v = (((c16 / q) * eb) * codec.QT_FACTOR + side).astype(np.float32)
        back = ((v - side) / (eb * codec.QT_FACTOR)) * q
        coef = np.where(out_ac, back, coef)
    else:
        coef = np.where(inr, coef, c16.astype(np.float32))
    coef[:, 0] = c16[:, 0].astype(np.float32)
    dec = _bf16_product(coef, basis, device).reshape(-1)[:x_seg.size] * sf
    return coef, inr, dec


def readings(x: np.ndarray, config: dict, seed: int, frames_checked: int,
             device) -> dict:
    """check.check's readings of one field under the control."""
    cc = config["codec"]
    eb = float(cc["error_bound"])
    whole = check.Whole.of(x, config)
    unit, sf = whole.unit, whole.sf
    want = check._expected_frames(x.size, config["container"])
    offs = np.concatenate(([0], np.cumsum(want)))
    rng = random.Random(int(seed) ^ 0xC0EF)
    picks = sorted(rng.sample(range(len(want)), min(frames_checked, len(want))))
    r = {"bad": 0, "bound": 0.0, "decode_gap": 0.0, "coef_gap": 0.0}
    for k in picks:
        lo, hi = int(offs[k]), int(offs[k + 1])
        coef, binned, dec = frame(x[lo:hi], sf, config, device)
        ref = codec.inverse(coef, sf)[:hi - lo]
        r["bound"] = max(r["bound"], float(np.abs(x[lo:hi] - dec).max()) / unit)
        r["decode_gap"] = max(r["decode_gap"], float(np.abs(dec - ref).max()) / unit)
        r["coef_gap"] = max(r["coef_gap"], check.coef_gap(
            x[lo:hi], sf, coef, binned, eb, 1.0, cc["mode"] != "qt"))
    return r
