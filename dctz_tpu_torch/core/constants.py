"""Core constants of the DCTZ-TPU codec.

These mirror the reference's compile-time constants (reference: dctz.h:23-30,
dctz.h:63-66) but are runtime values here: one library serves every mode.

Reference parity map:
  BLK_SZ      <- reference dctz.h:28
  BRSF        <- reference dctz.h:29
  SF_ADJ_AMT  <- reference dctz.h:30
  NBITS/NBINS <- reference dctz.h:65-66
  EB_MIN      <- reference dctz-comp-lib.c:135-138 (eb < 1E-6 rejected)
  QT_FACTOR   <- reference dctz-comp-lib.c:471-476 (10.0 when NBINS==255)
"""

from __future__ import annotations

VERSION = "0.1.0"

# Reference container version we interoperate with (dctz.h:23).
REF_VERSION = "0.2.2"

#: Block size of the 1-D DCT decomposition.
BLK_SZ = 64

#: Bin-range scaling factor (1.0 = bins exactly 2*eb wide).
BRSF = 1.0

#: Scaling-factor exponent adjustment: sf = 10**(ceil(log10(max|x|)) - SF_ADJ_AMT).
SF_ADJ_AMT = 1

#: Bits per stored bin index.
NBITS = 8

#: Number of regular quantization bins; bin id NBINS (=255) is the escape code.
NBINS = (1 << NBITS) - 1

#: Escape bin id: coefficient stored out-of-band in the AC_exact stream.
ESCAPE = NBINS

#: Hard floor on the error bound (reference rejects smaller bounds).
EB_MIN = 1e-6


def qt_factor(nbins: int = NBINS) -> float:
    """QT-mode renormalization factor (dctz-comp-lib.c:473)."""
    return 10.0 if nbins == 255 else 2000.0
