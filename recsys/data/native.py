"""ctypes bridge to the native C++ data plane (native/criteo_parser.cc).

Builds the shared library on first use (g++ -O3) and caches it; every entry
point has a pure-python fallback so the framework degrades gracefully where
no compiler exists. Hash parity with `recsys.data.hashing` is asserted
in tests/test_native.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "criteo_parser.cc")
_SRC_GATHER = os.path.join(_REPO_ROOT, "native", "row_gather.cc")
_BUILD_DIR = os.path.join(_REPO_ROOT, "native", "build")
_SO = os.path.join(_BUILD_DIR, "libcriteo_parser.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
             "-o", _SO, _SRC, _SRC_GATHER],
            check=True, capture_output=True, timeout=120,
        )
        return True
    except Exception:
        return False


def get_lib():
    """The loaded CDLL, or None when native support is unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        srcs = [s for s in (_SRC, _SRC_GATHER) if os.path.exists(s)]
        if not os.path.exists(_SO) or (
            srcs and max(os.path.getmtime(s) for s in srcs)
            > os.path.getmtime(_SO)
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.parse_criteo_tsv.restype = ctypes.c_long
        lib.parse_criteo_tsv.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_long),
        ]
        if hasattr(lib, "gather_rows"):
            lib.gather_rows.restype = None
            lib.gather_rows.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def parse_criteo_bytes(
    data: bytes, cat_vocabs: tuple[int, ...], max_rows: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """TSV bytes → (labels [N], cont [N,13] NaN-missing, cat_ids [N,26],
    bytes_consumed). Native fast path."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native parser unavailable")
    if max_rows is None:
        max_rows = data.count(b"\n") + 1
    labels = np.empty(max_rows, np.float32)
    cont = np.empty((max_rows, 13), np.float32)
    cat = np.empty((max_rows, 26), np.int32)
    vocabs = np.asarray(cat_vocabs, np.int32)
    consumed = ctypes.c_long(0)
    n = lib.parse_criteo_tsv(
        data, len(data), max_rows,
        vocabs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cont.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(consumed),
    )
    return labels[:n], cont[:n], cat[:n], consumed.value


def gather_rows(src: np.ndarray, idx: np.ndarray,
                n_threads: int | None = None) -> np.ndarray:
    """out[i] = src[idx[i]] — the host pipeline's shuffle gather
    (native/row_gather.cc), threaded memcpy per row slice. Falls back to
    numpy fancy indexing when the native library is unavailable.

    Indices must lie in [0, len(src)); negatives raise IndexError on both
    paths (the native path is a raw memcpy, so the contract is enforced here
    rather than diverging by build availability)."""
    src = np.ascontiguousarray(src)
    idx64 = np.ascontiguousarray(idx, np.int64)
    if len(idx64) and (idx64.min() < 0 or idx64.max() >= len(src)):
        raise IndexError(
            f"gather_rows: index out of range [0, {len(src)}) "
            f"(min={idx64.min()}, max={idx64.max()}); negative indices are "
            "not supported")
    lib = get_lib()
    if lib is None or not hasattr(lib, "gather_rows"):
        return src[idx64]
    out = np.empty((len(idx64),) + src.shape[1:], src.dtype)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    lib.gather_rows(
        src.ctypes.data_as(ctypes.c_char_p),
        out.ctypes.data_as(ctypes.c_char_p),
        idx64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(idx64), row_bytes, int(n_threads),
    )
    return out
