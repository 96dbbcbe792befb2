"""Build the CUDA kernels of csrc/ at first use and bind them with ctypes.

Each source is compiled by its own nvcc process, all started together, and
the objects are linked into one shared library with a plain C interface,
build/kernels/libdctz_kernels.so at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         -Xptxas -v -c -o build/kernels/<name>.o csrc/<name>.cu   (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/kernels/libdctz_kernels.so build/kernels/*.o

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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    # x, basis, sf, n, rmin, rmax, qmax_bits, stream
    "dctz_qtable_qmax": [P, P, P, I64, F32, F32, P, P],
    # x, basis, sf, tol, n_pad, n_valid, rmin, rmax, w, verify,
    # ids, coef, ok_tiles, counters, stream
    "dctz_dct_quant_verify": [P, P, P, P, I64, I64, F32, F32, F32, I32,
                              P, P, P, P, P],
    # x, basis, sf, tol, qtable, eb, qtf, n_pad, n_valid, rmin, rmax, w,
    # verify, ids, vals, ok_tiles, counters, stream
    "dctz_dct_quant_verify_qt": [P, P, P, P, P, F32, F32, I64, I64, F32, F32,
                                 F32, I32, P, P, P, P, P],
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
    # ids, acv, dc, basis, tail_basis, sf, nblk, rem, w, qtable, rmin, rmax,
    # denom, out, stream
    "dctz_dequant_idct_qt": [P, P, P, P, P, P, I64, I32, F32, P, F32, F32,
                             F32, P, P],
    # x, basis, sf, n_pad, rmin, rmax, w, ids, dcac, stream
    "dctz_dct_quant": [P, P, P, I64, F32, F32, F32, P, P, P],
    # x, basis, sf, qtable, eb, qtf, n_pad, rmin, rmax, w, ids, dcac, stream
    "dctz_dct_quant_qt": [P, P, P, P, F32, F32, I64, F32, F32, F32, P, P, P],
    # mask, vals, nc, cw, capc, rows, counts, word_walk, stream
    "dctz_chunk_compact": [P, P, I64, I32, I32, P, P, I32, P],
    # mask, rows, nc, cw, capc, out, stream
    "dctz_chunk_expand": [P, P, I64, I32, I32, P, P],
    # mask, vals, nc, cw, capc, rows, word_walk, stream
    "dctz_chunk_compact_bytes": [P, P, I64, I32, I32, P, I32, P],
    # mask, idb, vals, nc, cw, cape, capc, cut, exc, ac, word_walk, stream
    "dctz_chunk_compact_unified": [P, P, P, I64, I32, I32, I32, I32, P, P, I32,
                                   P],
    # x, basis, sf, n, rmin, rmax, w, width, packed, exc, ac, exc_counts,
    # ac_counts, dc, stream
    "dctz_fused_encode_dpk": [P, P, P, I64, F32, F32, F32, P, P, P, P, P, P,
                              P, P],
    # width, packed, exc_rows, ac_rows, dc, basis, sf, qtable, nblk, nce,
    # ncc, b, cw, cape, capc, w, rmin, rmax, denom, qt, out, stream
    "dctz_fused_decode_dpk": [P, P, P, P, P, P, P, P, I64, I64, I64, I32, I32,
                              I32, I32, F32, F32, F32, F32, I32, P, P],
    # b, cw: 1 where M takes its word walk, 0 where its lane walk
    "dctz_fused_decode_dpk_word_walk": [I32, I32],
    # packed, packed_off, packed_rows, packed_cap, packed_out, exc, exc_off,
    # exc_rows, exc_cap, exc_out, ac, ac_plane, ac_off, ac_rows, ac_cap,
    # ac_planes, ac_out, stream
    "dctz_dpk_rows_layout": [P, P, I64, I32, P, P, P, I64, I32, P, P, I64, P,
                             I64, I32, I32, P, P],
}
#: the RELAXED instantiations of A, A-QT, E, F and G (dct_precision "high":
#: the bf16x3 analysis on the tensor cores, csrc/dct_tile.cuh): the same
#: arguments as their HIGHEST instantiations
RELAXED = ("dct_quant_verify", "dct_quant_verify_qt", "qtable_qmax", "dct_quant",
           "dct_quant_qt")
SIGNATURES.update({f"dctz_{k}_relaxed": SIGNATURES[f"dctz_{k}"] for k in RELAXED})
#: the card-only references of L and M (csrc/*_ref.cu): the same arguments
#: as the kernels they check; only ops/research/_ref.py calls them
REFERENCES = ("fused_encode_dpk_ref", "fused_decode_dpk_ref")
SIGNATURES.update({f"dctz_{k}": SIGNATURES[f"dctz_{k.removesuffix('_ref')}"]
                   for k in REFERENCES})
#: kernels whose resident CTAs per SM at their launch configuration the
#: library reports (dctz_ctas_per_sm_<name>, no arguments)
OCCUPANCY = ("qtable_qmax", "dct_quant_verify", "dct_quant_verify_qt",
             "dpk_pack_compact", "dpk_unpack_expand", "dequant_idct",
             "dequant_idct_qt", "dct_quant", "dct_quant_qt", "chunk_compact",
             "chunk_expand", "chunk_compact_unified", "chunk_compact_bytes",
             "fused_encode_dpk", "fused_decode_dpk", "dpk_rows_layout") + tuple(
                 f"{k}_relaxed" for k in RELAXED)
#: the lane walks of H, J and K (csrc/chunk_shuffle.cu), their second
#: instantiations, whose resident CTAs per SM the library reports too
LANE_WALKS = ("chunk_compact_lanes", "chunk_compact_unified_lanes",
              "chunk_compact_bytes_lanes")
SIGNATURES.update({f"dctz_ctas_per_sm_{k}": [] for k in OCCUPANCY + LANE_WALKS + REFERENCES})


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
    """Compile csrc/*.cu into LIB_PATH unless it is up to date: one nvcc per
    source, all running at once, then one link."""
    global last_build_s
    if not force and not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [BUILD_DIR / (src.stem + ".o") for src in sources()]
    procs = [
        subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources(), objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    PTXAS_LOG.write_text("".join(logs))
    failed = [(src.name, log) for src, proc, log in zip(sources(), procs, logs)
              if proc.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name}:\n{log[-4000:]}" for name, log in failed))
    tmp = LIB_PATH.with_suffix(".so.tmp")
    res = subprocess.run([nvcc(), *ARCH, "-shared", "-o", str(tmp),
                          *map(str, objs)], capture_output=True, text=True)
    last_build_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def ctas_per_sm(name: str) -> int:
    """Resident CTAs per SM of kernel `name` on the current device
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its launch
    configuration); -1 if the runtime refused the query."""
    return getattr(lib(), f"dctz_ctas_per_sm_{name}")()


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
