"""Build and bind ``csrc/tiles_resid.cu`` (the CUDA side of ops/band.py; the
JAX package has no counterpart: Pallas compiled its kernel inside jit).

nvcc compiles the source into a shared library with a plain C interface,
on first use, into the package's gitignored ``_build/`` directory, under a
name keyed by a hash of the source's content. ctypes loads it; every pointer
and the stream pass as ``c_void_p``. The C function returns
``cudaGetLastError()`` after the launch and the wrapper raises if it is not
0. Nothing here falls back to the plain version: a kernel that does not
build or launch is an error.

Only ops/band.py imports this module, and only for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "tiles_resid.cu"
_BUILD = _PKG / "_build"  # gitignored
_SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build() -> tuple[Path, str]:
    """Compile the kernel library if this source has not been built yet.
    Returns (library path, compiler output: ptxas' register and shared
    memory report, empty when the library was already built)."""
    src_hash = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    lib_path = _BUILD / f"libtiles_resid.{src_hash}.so"
    if lib_path.exists():
        return lib_path, ""
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD / f"{lib_path.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    tmp.replace(lib_path)  # atomic: concurrent loaders see whole files
    return lib_path, res.stderr


def _load():
    global _lib
    if _lib is None:
        lib_path, _ = build()
        lib = ctypes.CDLL(str(lib_path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.cvdb_tiles_resid.argtypes = [vp] * 10 + [ci] * 8 + [vp]
        lib.cvdb_tiles_resid.restype = ci
        lib.cvdb_tiles_resid_smem_bytes.argtypes = [ci, ci]
        lib.cvdb_tiles_resid_smem_bytes.restype = ci
        lib.cvdb_cuda_error_string.argtypes = [ci]
        lib.cvdb_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _need(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def tiles_resid_slots(db_resid, local_ids, centroid_tiles, q_bf16, q8, row_scale,
                      tile_table, valid_end, *, tile_n: int, tile_q: int,
                      l_buckets: int):
    """Launch the scan: (Q_pad, L) f32 slot values and (Q_pad, L) int32 arena
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
    lib = _load()
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
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.cvdb_cuda_error_string(rc).decode()
        raise RuntimeError(f"tiles_resid kernel launch failed: {msg} ({rc})")
    return out_v, out_i
