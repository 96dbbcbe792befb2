"""Build the CUDA kernels of csrc/ at first use and bind them with ctypes.

The sources are compiled by nvcc into one shared library with a plain C
interface, build/kernels/libdctz_kernels.so at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/libdctz_kernels.so csrc/*.cu

Never with --use_fast_math: the bin ids depend on IEEE division in x/sf and
in (v - rmin)/w. Every C entry point returns cudaGetLastError(); the
wrappers in ops/dpk_fuse.py raise when it is not 0. The library is rebuilt
when any source is newer than it. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libdctz_kernels.so"
PTXAS_LOG = BUILD_DIR / "ptxas.txt"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: seconds the last compilation took (0.0 until one ran in this process)
last_build_s = 0.0

P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int
F32 = ctypes.c_float

#: C signatures: every pointer and the stream are c_void_p
SIGNATURES = {
    # x, basis, sf, tol, n_pad, n_valid, rmin, rmax, w, verify,
    # ids, coef, ok_tiles, stream
    "dctz_dct_quant_verify": [P, P, P, P, I64, I64, F32, F32, F32, I32,
                              P, P, P, P],
    # ids, vals, nblk, n_valid, cw, cape, width, packed, exc, ac,
    # exc_counts, ac_counts, dc, stream
    "dctz_dpk_pack_compact": [P, P, I64, I64, I32, I32, P, P, P, P, P, P,
                              P, P],
    # width, packed, exc, ac, nblk, nc, n_stream, cw, cape, capc,
    # ids, acv, stream
    "dctz_dpk_unpack_expand": [P, P, P, P, I64, I64, I64, I32, I32, I32,
                               P, P, P],
    # ids, acv, dc, basis, tail_basis, sf, nblk, rem, w, out, stream
    "dctz_dequant_idct": [P, P, P, P, P, P, I64, I32, F32, P, P],
}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    t = LIB_PATH.stat().st_mtime
    deps = sources() + sorted(CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > t for p in deps)


def build(force: bool = False) -> pathlib.Path:
    """Compile csrc/*.cu into LIB_PATH unless it is up to date."""
    global last_build_s
    if not force and not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(".so.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    last_build_s = time.perf_counter() - t0
    PTXAS_LOG.write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}"
        )
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib
