"""Dataset registry and list-file parsing (tests/list-*.txt equivalents).

The reference evaluates on externally downloaded datasets listed in
tests/list-msst19.txt (6 float64 1-D arrays, 12960-37024 elements) and
tests/list-CESM-ATM-tylor.txt (5 float32 3600x1800 2-D fields), driven by
tests/test-dctz.sh. Real files are used when present; otherwise each entry
falls back to a synthetic generator shaped like its science domain, so the
whole harness is runnable in a clean checkout.

A copy of dctz_tpu.eval.datasets: each entry loads the same bytes, real or
synthetic (tools/rand_gen, the port's own copy of the generator).
"""

from __future__ import annotations

import dataclasses
import pathlib
import zlib

import numpy as np

from ..tools.rand_gen import generate


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    dims: tuple[int, ...]
    dtype: str  # "f64" | "f32"
    kind: str  # synthetic generator kind when the real file is absent
    path: str | None = None

    @property
    def n(self) -> int:
        return int(np.prod(self.dims))

    @property
    def np_dtype(self):
        return np.float64 if self.dtype == "f64" else np.float32

    def load(self, data_dir: str | pathlib.Path | None = None) -> np.ndarray:
        if self.path:
            candidates = [pathlib.Path(self.path)]
            if data_dir:
                candidates.append(pathlib.Path(data_dir) / self.path)
            for c in candidates:
                if c.exists():
                    need = self.n * self.np_dtype().itemsize
                    have = c.stat().st_size
                    if have < need:
                        # a short file would silently truncate via
                        # np.fromfile(count=...) and poison the metrics
                        raise ValueError(
                            f"{c} holds {have} bytes, expected >= {need} "
                            f"({self.n} x {self.dtype}) — wrong dims or a "
                            "truncated download"
                        )
                    return np.fromfile(c, dtype=self.np_dtype, count=self.n)
        # stable across processes (Python's str hash is salted per run)
        seed = zlib.crc32(self.name.encode()) % (1 << 31)
        return generate(self.n, self.kind, seed).astype(self.np_dtype)

    def source(self, data_dir: str | pathlib.Path | None = None) -> str:
        """'real' when the reference dataset file is present, else
        'synthetic' (generator shaped like the science domain). Recorded
        per CSV row so quality claims are never silently unanchored."""
        if self.path:
            candidates = [pathlib.Path(self.path)]
            if data_dir:
                candidates.append(pathlib.Path(data_dir) / self.path)
            if any(c.exists() for c in candidates):
                return "real"
        return "synthetic"


# The MSST'19 suite (tests/list-msst19.txt:1-6; zc-patches/varInfo.txt:1-6).
MSST19 = [
    Dataset("sedov", (31040,), "f64", "climate", "sedov_p_3d.bin.f64"),
    Dataset("cellular", (32768,), "f64", "climate", "cellular_v_3d.bin.f64"),
    Dataset("rlds", (12960,), "f64", "smooth", "rlds.bin.f64"),
    Dataset("mrsos", (12960,), "f64", "smooth", "mrsos.bin.f64"),
    Dataset("eddy", (16384,), "f64", "climate", "eddy_v.bin.f64"),
    Dataset("vortex", (37024,), "f64", "climate", "vortex_p.bin.f64"),
]

# CESM-ATM float32 2-D fields (tests/list-CESM-ATM-tylor.txt:1-5).
CESM_ATM = [
    Dataset("CLDHGH", (1800, 3600), "f32", "climate", "CLDHGH_1_1800_3600.dat"),
    Dataset("CLDLOW", (1800, 3600), "f32", "climate", "CLDLOW_1_1800_3600.dat"),
    Dataset("FLDSC", (1800, 3600), "f32", "smooth", "FLDSC_1_1800_3600.dat"),
    Dataset("FREQSH", (1800, 3600), "f32", "climate", "FREQSH_1_1800_3600.dat"),
    Dataset("PHIS", (1800, 3600), "f32", "smooth", "PHIS_1_1800_3600.dat"),
]

# BASELINE.json config 1: rand-gen 1M doubles.
RANDGEN = [Dataset("randgen-1M", (1_000_000,), "f64", "rand")]

# Spectrally-shaped fields (1/f^alpha noise): neither trivially linearly
# predictable (unlike the sinusoid kinds, which hand sz_like its best case)
# nor spectrum-free (which would hand the DCT its worst) — the honest
# middle ground for synthetic rate-distortion comparisons.
SPECTRAL = [
    Dataset("pink-1M", (1_000_000,), "f32", "spectral"),
    Dataset("brown-1M", (1_000_000,), "f32", "spectral2"),
    Dataset("violet-1M", (1_000_000,), "f64", "spectral05"),
]

SUITES = {
    "msst19": MSST19,
    "cesm-atm": CESM_ATM,
    "randgen": RANDGEN,
    "spectral": SPECTRAL,
}


def parse_list_file(path: str | pathlib.Path, dtype: str = "f64") -> list[Dataset]:
    """Parse a reference-style dataset list: `path [dims...]` per line
    (tests/test-dctz.sh:13-56 consumes these)."""
    out = []
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        fname = parts[0]
        dims = tuple(int(d) for d in parts[1:]) or None
        if dims is None:
            raise ValueError(f"no dims for {fname}")
        out.append(
            Dataset(pathlib.Path(fname).stem, dims, dtype, "climate", fname)
        )
    return out
