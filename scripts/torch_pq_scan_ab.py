#!/usr/bin/env python3
"""A/B of K5/K6 builds (csrc/pq_scan.cu and variants of it) on one GPU, in
turns.

Run from the repository root::

    python3 scripts/torch_pq_scan_ab.py [SOURCE.cu ...]

The package's csrc/pq_scan.cu comes first, then each SOURCE.cu given (a
whole variant of it, with the same C interface). Each is built by nvcc (all
at once), bound in place of the package's pq_scan library, held against the
plain version and timed (CUDA events, median) at four shapes: K5 at BASELINE
config #3's PQ-route plans (B 4096, 224 table entries of tile_q 32 over a
10M x 64-code arena of 1024-row tiles with W 24 centroid rows; L 1024, L
256, and L 512 with top-2; random codes and tables made on the device) and
K6 over 1M x 64 codes at B 4096. The builds run in turns (forward, then
backward) at each shape; the line per (shape, build) is the mean of its two
medians, beside the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as c  # noqa: E402
from cloudvectordb_tpu_torch.ops import _cuda, pq  # noqa: E402


def build(sources: list[Path], out: Path) -> dict[str, ctypes.CDLL]:
    """Each source built and bound as ops/_cuda.py binds pq_scan, by label
    (its position and file name)."""
    procs = {}
    for src in sources:
        lib = out / f"libpq_scan_{len(procs)}.so"
        cmd = [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(_cuda._CSRC),
               "-o", str(lib), str(src)]
        procs[f"{len(procs)}:{src.name}"] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        dll = ctypes.CDLL(str(lib))
        for fn, (argtypes, restype) in _cuda._SIGNATURES["pq_scan"].items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = restype
        print(f"[build] {name}: {c.ptxas_report(err)}", flush=True)
        libs[name] = dll
    return libs


def shapes(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    n_tiles, tile_n, w, d, m = 9766, 1024, 24, c.D, c.PQ_M
    codes = torch.randint(0, 256, (n_tiles * tile_n, m), generator=g, device=dev,
                          dtype=torch.uint8)
    local = torch.sort(torch.randint(0, w, (n_tiles, tile_n), generator=g, device=dev),
                       dim=1)[0].to(torch.uint8).reshape(-1)
    cb = torch.randn((m, 256, d // m), generator=g, device=dev) / d ** 0.5
    ct = (torch.randn((n_tiles, w, d), generator=g, device=dev) / d ** 0.5).to(torch.bfloat16)
    q = torch.randn((c.B, d), generator=g, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    table = torch.randint(0, n_tiles, (c.B // 32, 224), generator=g, device=dev,
                          dtype=torch.int32)
    for label, lb, top2 in (("rf64 L1024", 0, False), ("rf16 L256", 256, False),
                            ("rf64+top2 L512", 512, True)):
        args = dict(codes_cm=codes, codebooks=cb, queries_sorted=q, tile_table=table,
                    k=640, centroid_tiles=ct, tile_n=tile_n, tile_q=32, l_buckets=lb,
                    n_valid=n_tiles * tile_n - 100, row_major=True, local_ids=local, top2=top2)
        yield (f"K5 {label}", lambda a=args: pq.pq_tiles_topk(**a),
               lambda a=args: pq.pq_tiles_topk_reference(**a))
    del codes, local, ct
    cm = torch.randint(0, 256, (m, 1_000_000), generator=g, device=dev, dtype=torch.uint8)
    yield ("K6 1M", lambda: pq.pq_topk(cm, cb, q, c.K, tile_n=2048),
           lambda: pq.pq_topk_reference(cm, cb, q, c.K, tile_n=2048))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pq_scan_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    sources = [_cuda._CSRC / "pq_scan.cu", *map(Path, sys.argv[1:])]
    card = c.card_line()
    print(f"[env] card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, Path(tmp))
        variants = list(libs)
        for name, kernel, plain in shapes(dev):
            ms = {v: [] for v in variants}
            for order in (variants, variants[::-1]):
                for v in order:
                    _cuda._libs["pq_scan"] = libs[v]
                    if not ms[v]:
                        c.compare(f"{name} {v}", kernel, plain)
                    ms[v].append(c.time_ms(kernel, 3))
            for v in variants:
                print(f"[ab] {name} {v}: {sum(ms[v]) / 2:.3f} ms (medians "
                      f"{', '.join(f'{x:.3f}' for x in ms[v])}); {card}", flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
