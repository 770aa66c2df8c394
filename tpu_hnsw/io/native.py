"""ctypes bindings for the native IO library (cpp/io_native.cpp).

Compiled on demand with g++ (no pybind11 in this environment); every
entry point has a pure-numpy fallback, so the package works without a
toolchain — the native path is a large-scale (LAION-100M) throughput
optimization, not a hard dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False
#: why the last load() fell back to numpy (None when it did not)
LOAD_ERROR: str | None = None


def _src_path() -> str:
    return os.path.join(os.path.dirname(__file__), "..", "cpp", "io_native.cpp")


def _lib_path() -> str:
    # built inside the checkout (``.native_build/``, gitignored) unless
    # TPU_HNSW_NATIVE_DIR names another directory
    cache = os.environ.get(
        "TPU_HNSW_NATIVE_DIR",
        os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..",
                                      ".native_build")),
    )
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, "libtpuhnsw_io.so")


def load() -> ctypes.CDLL | None:
    """Compile (once) and load the native library; None if unavailable."""
    global _LIB, _TRIED, LOAD_ERROR
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = _lib_path()
        src = _src_path()
        try:
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", so, src, "-lpthread"],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            lib = ctypes.CDLL(so)
            lib.fvecs_read.restype = ctypes.c_long
            lib.fvecs_shape.restype = ctypes.c_int
            lib.bvecs_read.restype = ctypes.c_long
            lib.blob_write.restype = ctypes.c_long
            lib.blob_read.restype = ctypes.c_long
            lib.balanced_assign_greedy.restype = ctypes.c_long
            _LIB = lib
        except subprocess.CalledProcessError as e:
            LOAD_ERROR = f"g++ failed: {e.stderr.decode(errors='replace')}"
            _LIB = None
        except (OSError, AttributeError, subprocess.SubprocessError) as e:
            LOAD_ERROR = repr(e)
            _LIB = None
        return _LIB


def read_fvecs_native(path: str, count: int | None = None) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    rows = ctypes.c_long()
    dim = ctypes.c_int()
    if lib.fvecs_shape(path.encode(), ctypes.byref(rows), ctypes.byref(dim)) != 0:
        return None
    n = rows.value if count is None else min(rows.value, count)
    out = np.empty((n, dim.value), np.float32)
    got = lib.fvecs_read(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(n),
        ctypes.c_int(0),
        ctypes.c_int(0),
    )
    if got < 0:
        return None
    return out[:got]


def read_bvecs_native(path: str, count: int | None = None) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    # bvecs rows are discovered inside the C side; allocate from file size
    import os as _os

    size = _os.path.getsize(path)
    with open(path, "rb") as f:
        d = int(np.fromfile(f, np.int32, 1)[0])
    total = size // (4 + d)
    n = total if count is None else min(total, count)
    out = np.empty((n, d), np.float32)
    got = lib.bvecs_read(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(n),
        ctypes.c_int(0),
    )
    if got < 0:
        return None
    return out[:got]


def blob_write(path: str, arr: np.ndarray) -> bool:
    lib = load()
    data = np.ascontiguousarray(arr)
    if lib is None:
        data.tofile(path)
        return True
    raw = data.view(np.uint8).reshape(-1)
    got = lib.blob_write(
        path.encode(),
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_long(raw.nbytes),
        ctypes.c_int(0),
    )
    return got == raw.nbytes


def blob_read(path: str, shape, dtype) -> np.ndarray:
    lib = load()
    out = np.empty(shape, dtype)
    nbytes = out.nbytes
    if lib is None:
        return np.fromfile(path, dtype).reshape(shape)
    raw = out.view(np.uint8).reshape(-1)
    got = lib.blob_read(
        path.encode(),
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_long(nbytes),
        ctypes.c_int(0),
    )
    if got != nbytes:
        return np.fromfile(path, dtype).reshape(shape)
    return out


def balanced_assign_greedy_native(
    cand_i: np.ndarray, cand_d: np.ndarray, n_blocks: int,
    assign: np.ndarray, free: np.ndarray
) -> int | None:
    """Native greedy capacity-balanced assignment (see io_native.cpp).

    cand_i [n, t] int32 C-contiguous, cand_d [n, t] float32, assign [n]
    int64 pre-filled -1 (mutated), free [B] int64 capacities (mutated).
    Returns rows assigned, or None when the native library is missing.
    """
    lib = load()
    if lib is None:
        return None
    n, t = cand_i.shape
    return int(lib.balanced_assign_greedy(
        cand_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cand_d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(n), ctypes.c_int(t), ctypes.c_long(n_blocks),
        assign.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        free.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    ))
