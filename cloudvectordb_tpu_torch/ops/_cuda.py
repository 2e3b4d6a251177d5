"""Build and bind the hand-written kernels in ``csrc/*.cu`` (the CUDA side of
ops/band.py, ops/flat_topk.py and ops/attn.py; the JAX package has no
counterpart: Pallas compiled its kernels inside jit).

nvcc compiles each source into a shared library of its own with a plain C
interface, on first use, into the package's gitignored ``_build/``
directory, under a name keyed by a hash of the source and of every local
header it includes (``#include "x.cuh"``, followed transitively), so an
edited shared header never loads a stale library. ``build()`` starts one
nvcc per source, all at once. ctypes loads a library; every pointer and the
stream pass as ``c_void_p``. Each C function returns ``cudaGetLastError()``
after its launch and the wrapper raises if it is not 0. Nothing here falls
back to a plain version: a kernel that does not build or launch is an error.

The kernel wrappers (ops/band.py, ops/flat_topk.py, ops/attn.py) import
this module only for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"  # gitignored
_SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C functions of each library: name -> (argtypes, restype)
_SIGNATURES = {
    "tiles_resid": {
        "cvdb_tiles_resid": ([_VP] * 10 + [_CI] * 8 + [_VP], _CI),
        "cvdb_tiles_resid_smem_bytes": ([_CI, _CI], _CI),
        "cvdb_cuda_error_string": ([_CI], ctypes.c_char_p),
    },
    "tiles_scan": {
        "cvdb_tiles_scan": ([_CI] * 3 + [_VP] * 6 + [_CI] * 8 + [_VP], _CI),
        "cvdb_cuda_error_string": ([_CI], ctypes.c_char_p),
    },
    "mha_small_head": {
        "cvdb_mha_fwd": ([_CI] * 2 + [_VP] * 7 + [_CI] * 3 + [_CF, _CI, _VP], _CI),
        "cvdb_mha_bwd": ([_CI] * 2 + [_VP] * 11 + [_CI] * 3 + [_CF, _CI, _VP], _CI),
        "cvdb_cuda_error_string": ([_CI], ctypes.c_char_p),
    },
}
#: element types, as tiles_scan.cu numbers them
_ELEM = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: what mha_small_head.cu takes: row types, as it numbers them, and head widths
_ATTN_ELEM = {torch.float32: 0, torch.bfloat16: 1}
_ATTN_D = (16, 32, 64)
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources(src: Path) -> list[Path]:
    """``src`` and every local header it includes, transitively."""
    seen: list[Path] = []
    todo = [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [(path.parent / name).resolve()
                 for name in _INCLUDE.findall(path.read_text())]
    return seen


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    h = hashlib.sha256()
    for path in sorted(_sources(_CSRC / f"{name}.cu")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return _BUILD / f"lib{name}.{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, tuple[Path, str]]:
    """Compile the given sources (default: every ``csrc/*.cu``) that are not
    built yet, one nvcc each, all started together. Returns name ->
    (library path, compiler output: ptxas' register and shared memory
    report, empty when the library was already built)."""
    names = names or sorted(p.stem for p in _CSRC.glob("*.cu"))
    done: dict[str, tuple[Path, str]] = {}
    running = []
    for name in names:
        lib = lib_path(name)
        if lib.exists():
            done[name] = (lib, "")
            continue
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = _BUILD / f"{lib.name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-I", str(_CSRC), "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        running.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, lib, tmp, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu: nvcc failed ({proc.returncode}):\n{err}")
            continue
        tmp.replace(lib)  # atomic: concurrent loaders see whole files
        done[name] = (lib, err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        lib_file, _ = build([name])[name]
        lib = ctypes.CDLL(str(lib_file))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return _libs[name]


def _need(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _check(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    if rc != 0:
        msg = lib.cvdb_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")


def tiles_resid_slots(db_resid, local_ids, centroid_tiles, q_bf16, q8, row_scale,
                      tile_table, valid_end, *, tile_n: int, tile_q: int,
                      l_buckets: int):
    """Launch K1: (Q_pad, L) f32 slot values and (Q_pad, L) int32 arena
    rows, on the tensors' device and PyTorch's current stream. Shapes are
    checked by ops/band.py; this checks what the kernel reads raw."""
    dev = db_resid.device
    local_ids = local_ids.reshape(-1)
    for t, name, dt in ((db_resid, "db_resid", torch.int8),
                        (local_ids, "local_ids", torch.uint8),
                        (centroid_tiles, "centroid_tiles", torch.bfloat16),
                        (q_bf16, "q_bf16", torch.bfloat16),
                        (q8, "q8", torch.int8),
                        (row_scale, "row_scale", torch.float32),
                        (tile_table, "tile_table", torch.int32),
                        (valid_end, "valid_end", torch.int32)):
        _need(t, name, dt, dev)
    n, d = db_resid.shape
    nq = q8.shape[0]
    n_qt, p = tile_table.shape
    w = centroid_tiles.shape[1]
    if n >= 2**31:
        raise ValueError(f"arena rows {n} exceed the kernel's int32 row ids")
    lib = _load("tiles_resid")
    smem = lib.cvdb_tiles_resid_smem_bytes(d, w)
    if smem > _SMEM_MAX:
        raise ValueError(f"D={d}, W={w} need {smem} B of shared memory > {_SMEM_MAX}")
    out_v = torch.empty((nq, l_buckets), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, l_buckets), dtype=torch.int32, device=dev)
    rc = lib.cvdb_tiles_resid(
        db_resid.data_ptr(), local_ids.data_ptr(), centroid_tiles.data_ptr(),
        q_bf16.data_ptr(), q8.data_ptr(), row_scale.data_ptr(),
        tile_table.data_ptr(), valid_end.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), n_qt, tile_q, p, tile_n, l_buckets, d, w,
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, rc, "tiles_resid")
    return out_v, out_i


def tiles_scan_slots(source: int, db, q, table, sqnorm, *, n_qt: int, tile_q: int,
                     steps: int, tile_n: int, l_buckets: int, n_valid: int):
    """Launch the whole-row scan (K2, K3 or K7, by ``source``, numbered as
    ops/band.py's SCAN_*): (Q, L) f32 slot values and (Q, L) int32 arena
    rows, on the tensors' device and PyTorch's current stream. ``table`` is
    None (ALL), the (n_qt, steps) tile table (TABLE) or the (n_qt,) band
    starts (BAND);
    ``sqnorm`` is None or the (N,) f32 l2 bias. Shapes are checked by the
    callers; this checks what the kernel reads raw."""
    dev = db.device
    if db.dtype not in _ELEM or q.dtype not in _ELEM:
        raise TypeError(f"no scan for {q.dtype} queries x {db.dtype} rows")
    _need(db, "db", db.dtype, dev)
    _need(q, "queries", q.dtype, dev)
    if table is not None:
        _need(table, "table", torch.int32, dev)
    if sqnorm is not None:
        _need(sqnorm, "sqnorm", torch.float32, dev)
    n, d = db.shape
    nq = q.shape[0]
    if n >= 2**31:
        raise ValueError(f"arena rows {n} exceed the kernel's int32 row ids")
    if n_qt * -(-tile_q // 32) > 65535:
        raise ValueError(f"{n_qt} query tiles of {tile_q} exceed the launch grid")
    lib = _load("tiles_scan")
    out_v = torch.empty((nq, l_buckets), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, l_buckets), dtype=torch.int32, device=dev)
    rc = lib.cvdb_tiles_scan(
        source, _ELEM[q.dtype], _ELEM[db.dtype], db.data_ptr(), q.data_ptr(),
        None if table is None else table.data_ptr(),
        None if sqnorm is None else sqnorm.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(), n_qt, tile_q, steps, tile_n,
        l_buckets, d, n_valid, _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, rc, "tiles_scan")
    return out_v, out_i


def _attn_shapes(q, k, v, mask, d: int) -> tuple[int, int]:
    """Check what K4 reads raw and the widths it takes; returns (B, L).
    Shapes are checked by ops/attn.py."""
    if q.dtype not in _ATTN_ELEM:
        raise TypeError(f"mha_small_head: no kernel for {q.dtype} rows")
    dev = q.device
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _need(t, name, q.dtype, dev)
    _need(mask, "mask", torch.int32, dev)
    b, length, _ = q.shape
    if d not in _ATTN_D:
        raise ValueError(f"mha_small_head kernel: head width {d} (takes d in {_ATTN_D})")
    if length % 128 or length > 512:
        raise ValueError(f"mha_small_head kernel: L={length} (takes L % 128 == 0, L <= 512)")
    return b, length


def mha_fwd(q, k, v, mask, heads: int, d: int, scale: float):
    """Launch K4's forward: (o (B, L, H*d) in q's type, row max (B, H, L)
    f32, row sum (B, H, L) f32), on q's device and PyTorch's current
    stream."""
    b, length = _attn_shapes(q, k, v, mask, d)
    dev = q.device
    lib = _load("mha_small_head")
    o = torch.empty_like(q)
    row_max = torch.empty((b, heads, length), dtype=torch.float32, device=dev)
    row_sum = torch.empty_like(row_max)
    rc = lib.cvdb_mha_fwd(
        _ATTN_ELEM[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        o.data_ptr(), row_max.data_ptr(), row_sum.data_ptr(), b, length, heads, scale,
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, rc, "mha_small_head forward")
    return o, row_max, row_sum


def mha_bwd(q, k, v, mask, dout, row_max, row_sum, heads: int, d: int, scale: float):
    """Launch K4's backward (two kernels, dq then dk/dv) from the forward's
    row statistics: (dq, dk, dv), each (B, L, H*d) in q's type."""
    b, length = _attn_shapes(q, k, v, mask, d)
    dev = q.device
    _need(dout, "dout", q.dtype, dev)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    for t, name in ((row_max, "row_max"), (row_sum, "row_sum")):
        _need(t, name, torch.float32, dev)
        if tuple(t.shape) != (b, heads, length):
            raise ValueError(f"{name} {tuple(t.shape)} != {(b, heads, length)}")
    lib = _load("mha_small_head")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty_like(row_max)
    rc = lib.cvdb_mha_bwd(
        _ATTN_ELEM[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        dout.data_ptr(), row_max.data_ptr(), row_sum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), b, length, heads, scale,
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, rc, "mha_small_head backward")
    return dq, dk, dv
