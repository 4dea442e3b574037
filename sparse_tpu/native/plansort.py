"""ctypes binding for the native plan-construction sorts (_plansort.cpp).

Same lazy-build contract as ``io/fastmm.py``: compiled with the ambient g++
on first use, cached next to the source, and every entry point degrades to
NumPy when the toolchain or shared object is unavailable.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["argsort_u64", "spgemm_schedule", "rcm_order"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "_plansort.cpp"
_SO = _HERE / "_plansort.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", str(_SO), str(_SRC)],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            lib = ctypes.CDLL(str(_SO))
            lib.radix_argsort_u64.restype = ctypes.c_int64
            lib.spgemm_schedule.restype = ctypes.c_int64
            lib.rcm_order.restype = ctypes.c_int64
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def argsort_u64(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of non-negative integer keys.

    Native stable LSD radix sort when available (~10x NumPy's comparison
    sort on the plan-build hot path), else ``np.argsort(kind="stable")``.
    ``keys`` must be integer-typed with non-negative values fitting u64.
    """
    keys = np.ascontiguousarray(keys)
    if keys.dtype != np.uint64:
        if keys.size and int(keys.min()) < 0:
            raise ValueError("argsort_u64: negative keys")
        keys = keys.astype(np.uint64)
    lib = _load()
    if lib is None:
        return np.argsort(keys, kind="stable")
    out = np.empty(keys.size, np.int64)
    rc = lib.radix_argsort_u64(
        ctypes.c_void_p(keys.ctypes.data),
        ctypes.c_int64(keys.size),
        ctypes.c_void_p(out.ctypes.data),
    )
    if rc != 0:
        return np.argsort(keys, kind="stable")
    return out


def rcm_order(indptr: np.ndarray, cols: np.ndarray) -> np.ndarray | None:
    """Native reverse Cuthill-McKee ordering of an n x n CSR pattern
    (ops/reorder.rcm_order's core): returns ``perm`` with ``perm[k]`` = old
    index at new position k, or None when the native library is unavailable.
    Symmetrizes internally; bit-identical to the NumPy path (tests pin
    this)."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    n = indptr.size - 1
    perm = np.empty(max(n, 1), np.int64)
    rc = lib.rcm_order(
        ctypes.c_void_p(indptr.ctypes.data),
        ctypes.c_int64(n),
        ctypes.c_void_p(cols.ctypes.data),
        ctypes.c_void_p(perm.ctypes.data),
    )
    if rc != 0:
        return None
    return perm[:n]


def spgemm_schedule(a_indptr, a_indices, b_starts, b_cols, b_src,
                    k: int, F: int):
    """Native SpGEMM product schedule (ops/spgemm.spgemm_prepare's symbolic
    pass): returns ``(a_pos, b_pos, seg, out_rows, out_cols)`` with the
    products sorted by output coordinate, or None when the native library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    a_indptr = np.ascontiguousarray(a_indptr, np.int64)
    a_indices = np.ascontiguousarray(a_indices, np.int64)
    b_starts = np.ascontiguousarray(b_starts, np.int64)
    b_cols = np.ascontiguousarray(b_cols, np.int64)
    b_src = np.ascontiguousarray(b_src, np.int64)
    n = a_indptr.size - 1
    m = b_starts.size - 1
    a_pos = np.empty(F, np.int64)
    b_pos = np.empty(F, np.int64)
    seg = np.empty(F, np.int64)
    out_rows = np.empty(max(F, 1), np.int64)
    out_cols = np.empty(max(F, 1), np.int64)
    nse = lib.spgemm_schedule(
        ctypes.c_void_p(a_indptr.ctypes.data), ctypes.c_int64(n),
        ctypes.c_void_p(a_indices.ctypes.data),
        ctypes.c_void_p(b_starts.ctypes.data), ctypes.c_int64(m),
        ctypes.c_void_p(b_cols.ctypes.data),
        ctypes.c_void_p(b_src.ctypes.data),
        ctypes.c_int64(k), ctypes.c_int64(F),
        ctypes.c_void_p(a_pos.ctypes.data),
        ctypes.c_void_p(b_pos.ctypes.data),
        ctypes.c_void_p(seg.ctypes.data),
        ctypes.c_void_p(out_rows.ctypes.data),
        ctypes.c_void_p(out_cols.ctypes.data),
    )
    if nse < 0:
        return None
    return a_pos, b_pos, seg, out_rows[:nse], out_cols[:nse]
