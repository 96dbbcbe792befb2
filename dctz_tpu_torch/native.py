"""ctypes bindings for the native C++ reference codec (cpp/dctz_ref.cpp).

The native codec is the CPU oracle and baseline: it reproduces the reference
implementation's semantics (and container bytes) without FFTW. The library
is built on demand with `make -C cpp`; all entry points degrade gracefully
(`available()` -> False) when no compiler is present.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import threading

import numpy as np

_CPP_DIR = pathlib.Path(__file__).resolve().parent.parent / "cpp"
_LIB_PATH = _CPP_DIR / "libdctzref.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not _LIB_PATH.exists():
            try:
                subprocess.run(
                    ["make", "-C", str(_CPP_DIR), "-s"],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except (subprocess.SubprocessError, FileNotFoundError):
                _build_failed = True
                return None
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.dctz_ref_compress_v.restype = ctypes.c_size_t
        lib.dctz_ref_compress_v.argtypes = [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_uint32,
            ctypes.c_double,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.dctz_ref_decompress.restype = ctypes.c_int
        lib.dctz_ref_decompress.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_uint32,
        ]
        lib.dctz_ref_peek.restype = ctypes.c_int
        lib.dctz_ref_peek.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int),
        ]
        # stream filters (filters.cpp)
        lib.dctz_pack_ids4.restype = ctypes.c_size_t
        lib.dctz_pack_ids4.argtypes = [ctypes.c_void_p] + [ctypes.c_size_t] + [ctypes.c_void_p] * 2
        lib.dctz_unpack_ids4.restype = ctypes.c_size_t
        lib.dctz_unpack_ids4.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
        ]
        for f in (lib.dctz_shuffle, lib.dctz_unshuffle):
            f.restype = None
            f.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p]
        for f in (lib.dctz_pack_rows, lib.dctz_unpack_rows):
            f.restype = ctypes.c_size_t
            f.argtypes = [
                ctypes.c_void_p,
                ctypes.c_size_t,
                ctypes.c_size_t,
                ctypes.c_void_p,
                ctypes.c_void_p,
            ]
        # rANS codec (rans.cpp)
        lib.dctz_rans_bound.restype = ctypes.c_size_t
        lib.dctz_rans_bound.argtypes = [ctypes.c_size_t]
        lib.dctz_rans_compress.restype = ctypes.c_size_t
        lib.dctz_rans_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
        lib.dctz_rans_decompress.restype = ctypes.c_size_t
        lib.dctz_rans_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
        lib.dctz_rans_raw_size.restype = ctypes.c_size_t
        lib.dctz_rans_raw_size.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def compress(
    x: np.ndarray, error_bound: float, mode: str = "ec", verify: bool = False
) -> bytes:
    """Native reference compression -> v1 container bytes.

    verify=True runs the C++ verify-and-repair pass (the pointwise-bound
    guarantee; reference-faithful behavior keeps it off)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec unavailable (build failed?)")
    x = np.ascontiguousarray(x).reshape(-1)
    if x.dtype == np.float64:
        dt = 1
    elif x.dtype == np.float32:
        dt = 0
    else:
        raise TypeError(f"unsupported dtype {x.dtype}")
    cap = 56 + 2 * x.nbytes + 4 * x.size + 4096
    out = np.empty(cap, np.uint8)
    size = lib.dctz_ref_compress_v(
        dt,
        1 if mode == "qt" else 0,
        1 if verify else 0,
        x.ctypes.data,
        x.size,
        float(error_bound),
        out.ctypes.data,
        cap,
    )
    if size == 0:
        raise RuntimeError("native compression failed")
    return out[:size].tobytes()


def decompress(blob: bytes) -> np.ndarray:
    """Native reference decompression of a v1 container."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec unavailable (build failed?)")
    raw = np.frombuffer(blob, np.uint8)
    n = ctypes.c_uint32()
    eb = ctypes.c_double()
    dt = ctypes.c_int()
    if lib.dctz_ref_peek(raw.ctypes.data, raw.size, n, eb, dt) != 0:
        raise ValueError("bad container")
    dtype = np.float64 if dt.value == 1 else np.float32
    out = np.empty(n.value, dtype)
    rc = lib.dctz_ref_decompress(
        raw.ctypes.data, raw.size, dt.value, out.ctypes.data, n.value
    )
    if rc < 0:
        raise ValueError(f"native decompression failed: {rc}")
    return out


# ---------------------------------------------------------------------------
# Native stream filters (filters.cpp) — used by core/entropy.py when built.
# ---------------------------------------------------------------------------


def pack_ids4(ids: np.ndarray) -> tuple[bytes, bytes]:
    lib = _load()
    n = ids.size
    assert n % 2 == 0
    packed = np.empty(n // 2, np.uint8)
    exc = np.empty(n, np.uint8)
    cnt = lib.dctz_pack_ids4(
        ids.ctypes.data, n, packed.ctypes.data, exc.ctypes.data
    )
    return packed.tobytes(), exc[:cnt].tobytes()


def unpack_ids4(packed: np.ndarray, exc: np.ndarray, n: int) -> np.ndarray:
    lib = _load()
    out = np.empty(n, np.uint8)
    rc = lib.dctz_unpack_ids4(
        packed.ctypes.data, n, exc.ctypes.data, exc.size, out.ctypes.data
    )
    if rc == ctypes.c_size_t(-1).value:
        raise ValueError(
            "corrupt ids4 stream: packed nibbles reference more exception "
            "bytes than the exception section holds"
        )
    return out


def shuffle(data: np.ndarray, itemsize: int) -> bytes:
    lib = _load()
    out = np.empty(data.size, np.uint8)
    lib.dctz_shuffle(data.ctypes.data, data.size, itemsize, out.ctypes.data)
    return out.tobytes()


def unshuffle(data: np.ndarray, itemsize: int) -> bytes:
    lib = _load()
    out = np.empty(data.size, np.uint8)
    lib.dctz_unshuffle(data.ctypes.data, data.size, itemsize, out.ctypes.data)
    return out.tobytes()


def pack_rows(rows: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Gather per-row prefixes (lens[i] bytes of each capacity row) into a
    tight stream — the DPK host-assembly hot loop, threaded memcpys."""
    lib = _load()
    rows = np.ascontiguousarray(rows, np.uint8)
    lens32 = np.ascontiguousarray(lens, np.uint32)
    if rows.ndim != 2 or lens32.ndim != 1 or lens32.size != rows.shape[0]:
        raise ValueError(
            f"pack_rows expects (n_rows, cap) rows + (n_rows,) lens, got "
            f"{rows.shape} / {lens32.shape}"
        )
    if lens32.size and int(lens32.max()) > rows.shape[1]:
        raise ValueError("row length exceeds capacity")
    out = np.empty(int(lens32.sum()), np.uint8)
    n = lib.dctz_pack_rows(
        rows.ctypes.data,
        rows.shape[0],
        rows.shape[1],
        lens32.ctypes.data,
        out.ctypes.data,
    )
    assert n == out.size
    return out


def unpack_rows(tight: np.ndarray, lens: np.ndarray, cap: int) -> np.ndarray:
    """Inverse of pack_rows -> zero-padded (n_rows, cap) capacity rows."""
    lib = _load()
    tight = np.ascontiguousarray(tight, np.uint8)
    lens32 = np.ascontiguousarray(lens, np.uint32)
    if tight.ndim != 1 or lens32.ndim != 1:
        raise ValueError(
            f"unpack_rows expects 1-D tight + 1-D lens, got "
            f"{tight.shape} / {lens32.shape}"
        )
    rows = np.empty((lens32.size, cap), np.uint8)
    n = lib.dctz_unpack_rows(
        tight.ctypes.data, lens32.size, cap, lens32.ctypes.data, rows.ctypes.data
    )
    if n == ctypes.c_size_t(-1).value:
        raise ValueError("row length exceeds capacity (corrupt container)")
    if n != tight.size:
        raise ValueError(
            f"tight stream length mismatch: {tight.size} != {n} expected"
        )
    return rows


def rans_compress(data) -> bytes:
    """See the JAX package's counterpart of this function."""
    lib = _load()
    if isinstance(data, np.ndarray):
        d = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    else:
        d = np.frombuffer(data, np.uint8)
    cap = lib.dctz_rans_bound(d.size)
    out = np.empty(cap, np.uint8)
    sz = lib.dctz_rans_compress(
        d.ctypes.data if d.size else None, d.size, out.ctypes.data, cap
    )
    if sz == 0 and d.size:
        raise RuntimeError("rans compression failed")
    return out[:sz].tobytes()


def rans_decompress(blob: bytes) -> bytes:
    lib = _load()
    b = np.frombuffer(blob, np.uint8)
    n = lib.dctz_rans_raw_size(b.ctypes.data, b.size)
    if n == ctypes.c_size_t(-1).value:
        raise ValueError("corrupt rans blob")
    out = np.empty(max(n, 1), np.uint8)
    sz = lib.dctz_rans_decompress(b.ctypes.data, b.size, out.ctypes.data, n)
    if sz != n:
        raise ValueError("rans decode mismatch")
    return out[:n].tobytes()
