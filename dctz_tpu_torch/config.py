"""Runtime configuration for the codec (PyTorch port).

The reference selects modes at compile time (-DUSE_QTABLE / -DUSE_TRUNCATE,
reference: Makefile:12-24) and bakes tunables into dctz.h. Here everything is
one runtime dataclass: a single library covers all four reference binaries
(dctz-ec-test / dctz-qt-test and their Z-Checker variants).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

from .core import constants as C

Mode = Literal["ec", "qt"]


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Full codec configuration: the same fields, defaults and validation
    as dctz_tpu.config.CodecConfig, whose docstring describes each field.

    The port runs one slice of this space (api.py: mode "ec", container
    "v2", ids_codec "device", float32 input, monolithic); compress() raises
    NotImplementedError, naming the ROADMAP item, for the rest.
    """

    mode: Mode = "ec"
    error_bound: float = 1e-3
    truncate: bool = True
    block_size: int = C.BLK_SZ
    nbins: int = C.NBINS
    brsf: float = C.BRSF
    sf_adj: int = C.SF_ADJ_AMT
    zlib_level: int = 6
    ids_zlib_level: int | None = None
    container: Literal["v1", "v2"] = "v1"
    shuffle: bool = True
    ids4: bool = True
    ids_codec: Literal["auto", "deflate", "rans", "device"] = "auto"
    float_codec: Literal["plane", "deflate"] = "plane"
    dc_delta: bool = False
    dpk_host_codec: Literal["none", "deflate", "rans", "zstd"] = "none"
    host_codec: Literal["auto", "zlib"] = "auto"
    chunk_bytes: int = 1 << 20
    internal_dtype: Literal["auto", "float32"] = "auto"
    verify: bool = False
    rate: Literal["fixed", "auto"] = "fixed"
    segment_elems: int | Literal["auto"] | None = "auto"
    dct_precision: Literal["highest", "high"] = "highest"

    def __post_init__(self) -> None:
        if self.mode not in ("ec", "qt"):
            raise ValueError(f"mode must be 'ec' or 'qt', got {self.mode!r}")
        if self.dct_precision not in ("highest", "high"):
            raise ValueError(
                f"dct_precision must be 'highest' or 'high', got "
                f"{self.dct_precision!r}"
            )
        if self.error_bound < C.EB_MIN:
            # Reference: "ERROR BOUND is not acceptable" (dctz-comp-lib.c:136).
            raise ValueError(
                f"error_bound {self.error_bound} below minimum {C.EB_MIN}"
            )
        if self.block_size < 2:
            raise ValueError("block_size must be >= 2")
        if not 1 <= self.nbins <= 255:
            raise ValueError("nbins must fit an 8-bit index with one escape code")

    @property
    def qt_factor(self) -> float:
        return C.qt_factor(self.nbins)

    @property
    def bin_width(self) -> float:
        return self.error_bound * 2.0 * self.brsf

    @property
    def range_max(self) -> float:
        # (2*(nbins//2)+1) * eb * brsf == nbins*eb for odd nbins
        # (dctz-comp-lib.c:271-281; decoder uses eb*NBINS, dctz-decomp-lib.c:373).
        half = self.nbins // 2
        return (half * 2 + 1) * (self.error_bound * self.brsf)

    @property
    def range_min(self) -> float:
        return -self.range_max
