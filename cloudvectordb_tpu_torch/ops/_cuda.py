"""Build and bind the hand-written kernels in ``csrc/*.cu`` (the CUDA side of
ops/band.py, ops/flat_topk.py, ops/pq.py, ops/rescore.py and ops/attn.py; the JAX
package has no counterpart: Pallas compiled its kernels inside jit).

nvcc compiles each source into a shared library of its own with a plain C
interface, on first use, into the package's gitignored ``_build/``
directory, under a name keyed by a hash of the source and of every local
header it includes (``#include "x.cuh"``, followed transitively), so an
edited shared header never loads a stale library. ``build()`` starts one
nvcc per source, all at once. ctypes loads a library; every pointer and the
stream pass as ``c_void_p``. Each C function returns ``cudaGetLastError()``
after its launch and the wrapper raises if it is not 0. Nothing here falls
back to a plain version: a kernel that does not build or launch is an error.

The kernel wrappers (ops/band.py, ops/flat_topk.py, ops/pq.py, ops/rescore.py,
ops/attn.py) import this module only for CUDA tensors.
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

_VP, _CI, _CF, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
#: C functions of each library: name -> (argtypes, restype)
_SIGNATURES = {
    "tiles_resid": {
        "cvdb_tiles_resid": ([_VP] * 15 + [_CI] * 9 + [_VP], _CI),
        "cvdb_tiles_resid_smem_bytes": ([_CI] * 7, _CI),
        "cvdb_tiles_resid_scratch_bytes": ([_CI] * 4, _CLL),
        "cvdb_resid_row_bias": ([_VP] * 4 + [_CLL] + [_CI] * 3 + [_CF, _CI, _VP], _CI),
        "cvdb_cuda_error_string": ([_CI], ctypes.c_char_p),
    },
    "tiles_scan": {
        "cvdb_tiles_scan": ([_CI] * 3 + [_VP] * 8 + [_CI] * 8 + [_VP], _CI),
        "cvdb_tiles_scan_smem_bytes": ([_CI] * 8, _CI),
        "cvdb_tiles_scan_block_queries": ([_CI] * 8, _CI),
        "cvdb_cuda_error_string": ([_CI], ctypes.c_char_p),
    },
    "pq_scan": {
        "cvdb_pq_scan": ([_CI, _CI, _VP, _CLL, _CLL] + [_VP] * 9 + [_CI] * 13 + [_VP], _CI),
        "cvdb_pq_scan_smem_bytes": ([_CI] * 6, _CI),
        "cvdb_pq_row_bias": ([_VP, _CLL, _CLL] + [_VP] * 4 + [_CLL] + [_CI] * 6 + [_VP], _CI),
        "cvdb_cuda_error_string": ([_CI], ctypes.c_char_p),
    },
    "rescore_int8": {
        "cvdb_rescore_int8": ([_VP] * 10 + [_CI] * 6 + [_CF] * 3 + [_CI] * 3 + [_VP], _CI),
        "cvdb_rescore_int8_smem_bytes": ([_CI] * 2, _CI),
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


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def tiles_resid_slots(db_resid, local_ids, centroid_tiles, q_bf16, q_dot, row_scale,
                      tile_table, valid_end, row_mask=None, row_bias=None, *, tile_n: int,
                      tile_q: int, l_buckets: int, top2: bool = False):
    """Launch K1 (its centroid-term prologue, then the scan): (Q_pad, L)
    f32 slot values and (Q_pad, L) int32 arena rows (top2: (Q_pad, 2·L),
    slot 1's buckets then slot 2's), on the tensors' device and PyTorch's
    current stream; the prologue's (n_qt, P, tile_q, W) f32 centroid term
    goes to a scratch tensor allocated here. ``q_dot`` is the residual
    term's queries, int8 or bf16 (the scan's hybrid pair); ``row_mask``
    (N,) uint8 and ``row_bias`` (N,) f32 are optional. Shapes are checked
    by ops/band.py; this checks what the kernel reads raw."""
    dev = db_resid.device
    local_ids = local_ids.reshape(-1)
    hybrid = q_dot.dtype == torch.bfloat16
    for t, name, dt in ((db_resid, "db_resid", torch.int8),
                        (local_ids, "local_ids", torch.uint8),
                        (centroid_tiles, "centroid_tiles", torch.bfloat16),
                        (q_bf16, "q_bf16", torch.bfloat16),
                        (q_dot, "q_dot", torch.bfloat16 if hybrid else torch.int8),
                        (row_scale, "row_scale", torch.float32),
                        (tile_table, "tile_table", torch.int32),
                        (valid_end, "valid_end", torch.int32),
                        (row_mask, "row_mask", torch.uint8),
                        (row_bias, "row_bias", torch.float32)):
        if t is not None:
            _need(t, name, dt, dev)
    n, d = db_resid.shape
    nq = q_dot.shape[0]
    n_qt, p = tile_table.shape
    w = centroid_tiles.shape[1]
    if n >= 2**31:
        raise ValueError(f"arena rows {n} exceed the kernel's int32 row ids")
    lib = _load("tiles_resid")
    smem = lib.cvdb_tiles_resid_smem_bytes(d, w, int(hybrid), int(row_mask is not None),
                                           int(row_bias is not None), int(top2),
                                           tile_n // l_buckets)
    if smem > _SMEM_MAX:
        raise ValueError(f"D={d}, W={w} need {smem} B of shared memory > {_SMEM_MAX}")
    cterm = torch.empty(lib.cvdb_tiles_resid_scratch_bytes(n_qt, tile_q, p, w),
                        dtype=torch.uint8, device=dev)
    out_v = torch.empty((2 if top2 else 1, nq, l_buckets), dtype=torch.float32, device=dev)
    out_i = torch.empty((2 if top2 else 1, nq, l_buckets), dtype=torch.int32, device=dev)
    rc = lib.cvdb_tiles_resid(
        db_resid.data_ptr(), local_ids.data_ptr(), centroid_tiles.data_ptr(),
        q_bf16.data_ptr(), q_dot.data_ptr(), row_scale.data_ptr(),
        tile_table.data_ptr(), valid_end.data_ptr(), _ptr(row_mask), _ptr(row_bias),
        cterm.data_ptr(), out_v[0].data_ptr(), out_i[0].data_ptr(),
        out_v[1].data_ptr() if top2 else None, out_i[1].data_ptr() if top2 else None,
        n_qt, tile_q, p, tile_n, l_buckets, d, w, int(hybrid),
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, rc, "tiles_resid")
    if top2:
        return torch.cat([out_v[0], out_v[1]], 1), torch.cat([out_i[0], out_i[1]], 1)
    return out_v[0], out_i[0]


def resid_row_bias(db_resid, local_ids, centroid_tiles, resid_scale: float, *, tile_n: int):
    """Launch K1's l2 bias kernel: (N,) f32, on the tensors' device and
    PyTorch's current stream. Shapes are checked by ops/band.py."""
    dev = db_resid.device
    local_ids = local_ids.reshape(-1)
    for t, name, dt in ((db_resid, "db_resid", torch.int8),
                        (local_ids, "local_ids", torch.uint8),
                        (centroid_tiles, "centroid_tiles", torch.bfloat16)):
        _need(t, name, dt, dev)
    n, d = db_resid.shape
    if d % 4:
        raise ValueError(f"D={d} must be a multiple of 4")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _load("tiles_resid")
    rc = lib.cvdb_resid_row_bias(
        db_resid.data_ptr(), local_ids.data_ptr(), centroid_tiles.data_ptr(), out.data_ptr(),
        n, tile_n, d, centroid_tiles.shape[1], float(resid_scale), _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, rc, "resid_row_bias")
    return out


def tiles_scan_slots(source: int, db, q, table, sqnorm, *, n_qt: int, tile_q: int,
                     steps: int, tile_n: int, l_buckets: int, n_valid: int,
                     top2: bool = False):
    """Launch the whole-row scan (K2, K3 or K7, by ``source``, numbered as
    ops/band.py's SCAN_*): (Q, L) f32 slot values and (Q, L) int32 arena
    rows (top2: (Q, 2·L), slot 1's buckets then slot 2's), on the tensors' device and
    PyTorch's current stream. ``table`` is None (ALL), the (n_qt, steps)
    tile table (TABLE) or the (n_qt,) band starts (BAND); ``sqnorm`` is
    None or the (N,) f32 l2 bias. top2 is K3's (source TABLE), on every
    pair the scan takes. Shapes are checked by the callers; this checks
    what the kernel reads raw."""
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
    lib = _load("tiles_scan")
    # the body the call takes: the tensor-core and f32 ones (dynamic shared
    # memory) put query blocks on grid x, the CUDA-core one on grid y
    body = (source, _ELEM[q.dtype], _ELEM[db.dtype], tile_q, d, int(sqnorm is not None),
            int(top2), tile_n // l_buckets)
    smem = lib.cvdb_tiles_scan_smem_bytes(*body)
    q_blocks = n_qt * -(-tile_q // lib.cvdb_tiles_scan_block_queries(*body))
    if q_blocks > (65535 if smem == 0 else 2**31 - 1):
        raise ValueError(f"{n_qt} query tiles of {tile_q} exceed the launch grid")
    out_v = torch.empty((2 if top2 else 1, nq, l_buckets), dtype=torch.float32, device=dev)
    out_i = torch.empty((2 if top2 else 1, nq, l_buckets), dtype=torch.int32, device=dev)
    rc = lib.cvdb_tiles_scan(
        source, _ELEM[q.dtype], _ELEM[db.dtype], db.data_ptr(), q.data_ptr(),
        _ptr(table), _ptr(sqnorm), out_v[0].data_ptr(), out_i[0].data_ptr(),
        out_v[1].data_ptr() if top2 else None, out_i[1].data_ptr() if top2 else None,
        n_qt, tile_q, steps, tile_n, l_buckets, d, n_valid, _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, rc, "tiles_scan")
    if top2:
        return torch.cat([out_v[0], out_v[1]], 1), torch.cat([out_i[0], out_i[1]], 1)
    return out_v[0], out_i[0]


def _pq_side(codes, local, cb, ct) -> None:
    """What the PQ scan and its bias kernel read raw besides the codes."""
    dev = codes.device
    if codes.dtype != torch.uint8:
        raise ValueError(f"codes: need uint8 on {dev}, got {codes.dtype}")
    _need(cb, "codebooks", torch.bfloat16, dev)
    if (ct is None) != (local is None):
        raise ValueError("the residual term needs both local ids and centroid tiles")
    if ct is not None:
        _need(ct, "centroid_tiles", torch.bfloat16, dev)
        if local.dtype != torch.uint8 or local.device != dev or local.stride(0) != 1:
            raise ValueError("local ids: need a contiguous uint8 vector on the device")


def pq_scan_slots(source: int, codes, local, cb, ct, q, table, row_mask=None, row_bias=None,
                  *, n_qt: int, tile_q: int, steps: int, tile_n: int, l_buckets: int,
                  n_valid: int, n_pools: int, top2: bool, n_live_tiles: int | None = None):
    """Launch the PQ scan (K5 with ``source`` TABLE, K6 with ALL, numbered
    as ops/band.py's SCAN_*): (n_slots, Q, L) f32 slot values and int32
    arena rows, on the tensors' device and PyTorch's current stream.
    ``codes`` is the (N, m) uint8 code of each row under any strides (the
    row-major arena, or a code-major matrix transposed); ``local`` (N,)
    uint8 and ``ct`` (n_tiles, W, D) bf16 are both None without a residual
    term; ``row_mask`` (N,) uint8 allow bytes and ``row_bias`` (N,) f32 l2
    bias are optional (K5); table entries at or past ``n_live_tiles`` are
    skipped. Shapes are checked by ops/pq.py; this checks what the kernel
    reads raw. Offsets into the codes are 64-bit."""
    dev = codes.device
    _pq_side(codes, local, cb, ct)
    _need(q, "queries", torch.bfloat16, dev)
    if table is not None:
        _need(table, "table", torch.int32, dev)
    for t, name, dt in ((row_mask, "row_mask", torch.uint8),
                        (row_bias, "row_bias", torch.float32)):
        if t is not None:
            _need(t, name, dt, dev)
            if t.numel() != codes.shape[0]:
                raise ValueError(f"{name}: {t.numel()} entries for {codes.shape[0]} rows")
    n, m = codes.shape
    nq, d = q.shape
    _, ncode, dsub = cb.shape
    if n >= 2**31:
        raise ValueError(f"arena rows {n} exceed the kernel's int32 row ids")
    if n_qt * -(-tile_q // 32) > 65535 or n_pools > 65535:
        raise ValueError(f"{n_qt} query tiles of {tile_q}, {n_pools} pools exceed the grid")
    w = 0 if ct is None else ct.shape[1]
    lib = _load("pq_scan")
    smem = lib.cvdb_pq_scan_smem_bytes(m, dsub, w, int(top2), int(row_mask is not None),
                                       int(row_bias is not None))
    if smem > _SMEM_MAX:
        raise ValueError(f"m={m}, dsub={dsub}, W={w} need {smem} B of shared memory "
                         f"> {_SMEM_MAX}")
    n_slots = n_pools * (2 if top2 else 1)
    out_v = torch.empty((n_slots, nq, l_buckets), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_slots, nq, l_buckets), dtype=torch.int32, device=dev)
    rc = lib.cvdb_pq_scan(
        source, int(top2), codes.data_ptr(), codes.stride(0), codes.stride(1),
        None if local is None else local.data_ptr(), cb.data_ptr(),
        None if ct is None else ct.data_ptr(), q.data_ptr(),
        None if table is None else table.data_ptr(), _ptr(row_mask), _ptr(row_bias),
        out_v.data_ptr(), out_i.data_ptr(),
        n_qt, tile_q, steps, tile_n, l_buckets, m, ncode, dsub, w, n_valid, n_pools,
        2**31 - 1 if n_live_tiles is None else n_live_tiles, _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, rc, "pq_scan")
    return out_v, out_i


def pq_row_bias(codes, local, cb, ct, *, tile_n: int):
    """Launch K5's l2 bias kernel: (N,) f32 -|x|^2 / 2 of every row of the
    (N, m) codes (any strides), on the tensors' device and PyTorch's
    current stream. Shapes are checked by ops/pq.py."""
    dev = codes.device
    _pq_side(codes, local, cb, ct)
    n, m = codes.shape
    _, ncode, dsub = cb.shape
    w = 0 if ct is None else ct.shape[1]
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _load("pq_scan")
    rc = lib.cvdb_pq_row_bias(
        codes.data_ptr(), codes.stride(0), codes.stride(1), _ptr(local), cb.data_ptr(),
        _ptr(ct), out.data_ptr(), n, tile_n, m, ncode, dsub, w, _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, rc, "pq_row_bias")
    return out


def rescore_int8(refine_rows, cand, v, q, scale: float, *, l2: bool, residual=None):
    """Launch the int8 rescore: (B, k_cand) f32 scores of each query's
    candidates against their refine rows, -inf where ``v`` is -inf, on the
    tensors' device and PyTorch's current stream. ``refine_rows`` (N, D)
    int8, D a multiple of 4 (the kernel loads a row by 4-byte words),
    ``cand`` (B, k_cand) int64 arena rows in [0, N) where ``v`` is live,
    ``v`` (B, k_cand) f32, ``q`` (B, D) f32 in planner order. ``residual``
    is None for whole rows, else (local (>= N,) uint8, tile_window
    (n_tiles, W) int64, dots (B, nlist) f32, order (B,) int64, centroids
    (nlist, D) f32, tile_n). Shapes are checked by ops/rescore.py; this
    checks what the kernel reads raw."""
    dev = refine_rows.device
    checks = [(refine_rows, "refine_rows", torch.int8), (cand, "cand", torch.int64),
              (v, "v", torch.float32), (q, "q", torch.float32)]
    local = window = dots = order = cents = None
    tile_n = 1
    if residual is not None:
        local, window, dots, order, cents, tile_n = residual
        local = local.reshape(-1)
        checks += [(local, "local_ids", torch.uint8), (window, "tile_window", torch.int64),
                   (dots, "dots", torch.float32), (order, "order", torch.int64),
                   (cents, "centroids", torch.float32)]
    for t, name, dt in checks:
        _need(t, name, dt, dev)
    d = refine_rows.shape[1]
    b, kc = cand.shape
    if d % 4:
        raise ValueError(f"D={d} must be a multiple of 4")
    if not 0 < b < 2**31 or kc == 0:
        raise ValueError(f"{b} queries of {kc} candidates: nothing to launch, or past the grid")
    lib = _load("rescore_int8")
    smem = lib.cvdb_rescore_int8_smem_bytes(d, kc)
    if smem > _SMEM_MAX:
        raise ValueError(f"D={d} needs {smem} B of shared memory > {_SMEM_MAX}")
    out = torch.empty((b, kc), dtype=torch.float32, device=dev)
    # the f32 constants (ctypes rounds each to f32, as ops/topk.py::f32_const)
    rc = lib.cvdb_rescore_int8(
        refine_rows.data_ptr(), cand.data_ptr(), v.data_ptr(), q.data_ptr(),
        _ptr(local), _ptr(window), _ptr(dots), _ptr(order), _ptr(cents), out.data_ptr(),
        b, kc, d, tile_n, 0 if window is None else window.shape[1],
        0 if dots is None else dots.shape[1], scale, 2.0 * scale, scale * scale,
        int(residual is not None), int(l2), _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, rc, "rescore_int8")
    return out


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
    """Launch K4's backward from the forward's row statistics (bf16 rows at
    L 128: one kernel; otherwise two, dq then dk/dv, through the delta
    scratch): (dq, dk, dv), each (B, L, H*d) in q's type."""
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
