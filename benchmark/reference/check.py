"""The comparison that decides `correct`, in float64 NumPy.

For one round trip of one field x (float32, host) it reads:

  bad         structural faults: a stream or container that does not parse
              (bad magic, a crc, a length), a frame count, an element count,
              an error bound, a mode, a scaling factor or a mean (the whole
              array's, in every frame) other than the deployment's. Exact:
              limit 0.
  bound       max |x - port decode| / (eb * range(x)) over the whole array:
              the configuration's pointwise bound. Limit 1.
  decode_gap  max |port decode - reference decode of the same container| /
              (eb * range(x)) over the checked frames: the port's decoder
              against this one, on what the container stores.
  coef_gap    max |stored coefficient - exact coefficient| / (eb * brsf)
              over the checked frames, the exact ones the float64 DCT of
              x / sf: the binned AC coefficients (a bin's center lies within
              eb of its coefficient) and, in EC, the escapes and the DC
              (stored as float32). QT escapes are left out: their
              renormalized float32 value is lossy by design.

`verify=True` repairs any sample out of the bound, so `bound` alone cannot
see a coarser transform: coef_gap reaches what the container stores.
"""

from __future__ import annotations

import dataclasses
import random
import struct
import zlib

import numpy as np

from . import codec, frozen
from . import container as ct

PARSE_ERRORS = (ValueError, IndexError, KeyError, struct.error, zlib.error)


@dataclasses.dataclass
class Whole:
    """What the check needs of the whole array: eb times its range, its
    scaling factor and mean."""

    eb: float
    qt: bool
    unit: float
    sf: float
    mean: float
    mean_tol: float  # float32 device sums stay far inside 1e-5 of max |x|

    @classmethod
    def of(cls, x: np.ndarray, config: dict) -> "Whole":
        cc = config["codec"]
        eb = float(cc["error_bound"])
        vmin, vmax = float(x.min()), float(x.max())
        amax = max(abs(vmin), abs(vmax))
        return cls(eb, cc["mode"] == "qt", eb * (vmax - vmin),
                   codec.scaling_factor(np.array([amax])),
                   float(x.mean(dtype=np.float64)), 1e-5 * amax)


def bound(x: np.ndarray, out: np.ndarray, unit: float,
          step: int = 1 << 20) -> float:
    """max |x - out| / unit (frozen.evaluate's arithmetic, a slice of
    `step` samples at a time so that its float64 scratch stays small)."""
    if out.shape != x.shape or out.dtype != x.dtype:
        return float("inf")
    xf, of = x.reshape(-1), out.reshape(-1)
    worst = max((frozen.evaluate(xf[lo:lo + step], of[lo:lo + step], 1.0)
                 ["max_abs_err"] for lo in range(0, xf.size, step)),
                default=0.0)
    return worst / unit


def coef_gap(x_seg: np.ndarray, sf: float, coef: np.ndarray,
             binned: np.ndarray, eb: float, brsf: float, ec: bool) -> float:
    """max |coef - exact| / (eb * brsf) over the binned AC coefficients and,
    in EC, the escapes and the DC of the blocks that hold x_seg."""
    nblk = -(-x_seg.size // coef.shape[1])
    exact = codec.forward(x_seg, sf, coef.shape[1])
    gap = np.abs(coef[:nblk] - exact)
    sel = binned[:nblk] if not ec else np.ones_like(binned[:nblk])
    return float(gap[sel].max(initial=0.0)) / (eb * brsf)


def _expected_frames(n: int, container: dict) -> list[int]:
    if container["kind"] != "dtzs":
        return [n]
    seg = int(container["segment_elems"])
    return [min(seg, n - off) for off in range(0, n, seg)]


def header_bad(c: ct.Container, n: int, whole: Whole) -> int:
    """1 when a frame's header says other than the deployment's."""
    return int(c.n != n or c.error_bound != whole.eb
               or c.has(ct.FLAG_QT) != whole.qt or not c.has(ct.FLAG_DPK)
               or abs(c.scaling_factor - whole.sf) > 1e-6 * whole.sf
               or abs(c.mean - whole.mean) > whole.mean_tol)


def frame(c: ct.Container, x_seg: np.ndarray, out_seg: np.ndarray | None,
          whole: Whole, pool=None) -> dict:
    """bad, decode_gap and coef_gap of one frame decoded by the reference;
    out_seg: the port's decode of the frame's samples (None: not read)."""
    r = {"bad": 0, "decode_gap": 0.0, "coef_gap": 0.0}
    try:
        ids, esc, dc, _ = codec.dpk_stored(c, pool)
    except PARSE_ERRORS as e:
        r["bad"] += 1
        r["error"] = f"{type(e).__name__}: {e}"
        return r
    coef, binned = codec.coefficients(c, ids, esc, dc)
    ref = codec.inverse(coef, c.scaling_factor)[:c.n]
    if out_seg is not None:
        r["decode_gap"] = float(np.abs(out_seg - ref).max()) / whole.unit
    r["coef_gap"] = coef_gap(x_seg, c.scaling_factor, coef, binned, whole.eb,
                             c.brsf, not whole.qt)
    return r


def check(x: np.ndarray, blob, out: np.ndarray, config: dict, seed: int,
          frames_checked: int, pool=None) -> dict:
    """The four readings of one round trip (see the module docstring);
    pool: rans.decompress's."""
    whole = Whole.of(x, config)
    r = {"bad": 0, "bound": bound(x, out, whole.unit), "decode_gap": 0.0,
         "coef_gap": 0.0}
    want = _expected_frames(x.size, config["container"])
    try:
        if config["container"]["kind"] == "dtzs":
            total, views = ct.frames(blob)
            if total != x.size:
                r["bad"] += 1
        else:
            views = [memoryview(blob)]
        if len(views) != len(want):
            r["bad"] += 1
            return r
        parsed = [ct.parse(v) for v in views]
    except PARSE_ERRORS as e:
        r["bad"] += 1
        r["error"] = f"{type(e).__name__}: {e}"
        return r
    r["bad"] += sum(header_bad(c, n, whole) for c, n in zip(parsed, want))
    rng = random.Random(int(seed) ^ 0xC0EF)
    picks = sorted(rng.sample(range(len(parsed)), min(frames_checked, len(parsed))))
    offs = np.concatenate(([0], np.cumsum(want)))
    readings = [r]
    for k in picks:
        lo, hi = int(offs[k]), int(offs[k + 1])
        if parsed[k].n == hi - lo:  # a wrong count is counted above
            readings.append(frame(parsed[k], x[lo:hi],
                                  out[lo:hi] if out.shape == x.shape else None,
                                  whole, pool))
    return combine(readings)


def combine(readings: list[dict]) -> dict:
    """The worst of each reading over the checked round trips."""
    out = {"bad": 0, "bound": 0.0, "decode_gap": 0.0, "coef_gap": 0.0}
    for r in readings:
        out["bad"] += r["bad"]
        if "error" in r:
            out.setdefault("error", r["error"])
        for k in ("bound", "decode_gap", "coef_gap"):
            out[k] = max(out[k], r.get(k, 0.0))
    return out
