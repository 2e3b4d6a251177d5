"""ctypes bridge to the shared host-side data plane, native/arena_sort.cpp
(counterpart of cloudvectordb_tpu/utils/native.py, whose loader this copies).

Compiled with g++ on first use into the repo's gitignored ``native/build/``,
under a file name of its own so the two packages never load each other's
build. Every entry point has a numpy fallback with identical results: this
is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from cloudvectordb_tpu_torch.utils.metrics import get_logger

log = get_logger("cvdb.native")

_REPO = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO / "native" / "arena_sort.cpp"
_BUILD = _REPO / "native" / "build"  # gitignored: binaries are never committed
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        # cache key = source-content hash: mtime is unreliable after a clone
        src_hash = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        lib_path = _BUILD / f"libarena_sort_torch.{src_hash}.so"
        if not lib_path.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = _BUILD / f"{lib_path.name}.{os.getpid()}.tmp"  # one per builder
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
                 "-pthread", str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True,
            )
            tmp.replace(lib_path)  # atomic: concurrent loaders see whole files
        lib = ctypes.CDLL(str(lib_path))
        lib.arena_sort.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.arena_sort.restype = None
        lib.gather_rows.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.gather_rows.restype = None
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as e:
        # no toolchain / build failure → numpy fallback
        log.warning("native arena_sort unavailable (%s); using numpy fallback", e)
        _lib = None
    return _lib


def arena_sort(assign: np.ndarray, nlist: int) -> tuple[np.ndarray, np.ndarray]:
    """Stable sort-by-list: returns (order (n,) i64, offsets (nlist+1,) i64)."""
    assign = np.ascontiguousarray(assign, np.int32)
    n = assign.shape[0]
    lib = _load()
    if lib is None:
        order = np.argsort(assign, kind="stable").astype(np.int64)
        counts = np.bincount(assign, minlength=nlist)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return order, offsets
    order = np.empty(n, np.int64)
    offsets = np.empty(nlist + 1, np.int64)
    lib.arena_sort(
        assign.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n), ctypes.c_int32(nlist),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return order, offsets


def gather_rows(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    """dst[i] = src[order[i]] — parallel row gather for arena payloads."""
    src = np.ascontiguousarray(src)
    order = np.ascontiguousarray(order, np.int64)
    lib = _load()
    if lib is None:
        return src[order]
    out = np.empty((order.shape[0], *src.shape[1:]), src.dtype)
    row_bytes = src.itemsize * int(np.prod(src.shape[1:], initial=1))
    lib.gather_rows(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(order.shape[0]), ctypes.c_int64(row_bytes),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out
