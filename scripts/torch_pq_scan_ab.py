#!/usr/bin/env python3
"""A/B of scan kernel builds (csrc/pq_scan.cu, csrc/tiles_scan.cu or
csrc/tiles_resid.cu, and variants of it) on one GPU, in turns.

Run from the repository root::

    python3 scripts/torch_pq_scan_ab.py [--source tiles_scan] [--only K2] [SOURCE.cu ...]

The package's csrc/<source>.cu (default pq_scan) comes first, then each
SOURCE.cu given (a whole variant of it, with the same C interface). Each is
built by nvcc
(all at once), bound in place of the package's library, held against the
plain version (through exact f64 scores where a shape gives them; a build
that fails the hold is logged and still timed) and
timed (CUDA events, median) at the source's shapes whose name starts with
``--only`` (default: all), random data made on the device:

- pq_scan: K5 at the opqpq10m.b4096 cell's plan (B 4096, 320 table entries
  of tile_q 64, two pools of L 1024 with top-2, k_cand 2050, W CELL_W: 64
  queries a block), at BASELINE config #3's PQ-route plans (B 4096, 224
  table entries of tile_q 32 over a 10M x 64-code arena of 1024-row tiles
  with W 24 centroid rows; L 1024, L 256, and L 512 with top-2: 32 queries
  a block) and K6 over 1M x 64 codes at B 4096 (64 a block);
- tiles_scan: K3 at the whole-row path's plan (B 4096, 96 table entries of
  tile_q 32 over a 12.5M x 768 int8 arena of 2048-row tiles; hybrid and
  int8 queries, and hybrid with top-2), K7 at its band plan (int8, tile_q 256, a band of every
  tile), and K2 at the flat cells' shapes: f32 l2 over 1M x 128 integer
  rows in [0, 255] against 10,000 such queries, int8 over 1M x 768 against
  4096 queries, f32 ip over 1M x 384 unit rows against 10,000 queries;
- tiles_resid: K1 at the residual path's plan (B 4096, tile_q 32, 96 table
  entries over a 12.5M x 768 int8 arena of 2048-row tiles with W 36
  centroid rows a tile and valid_end holes), there also with each contract
  variant ('precise', a 10% row mask, l2 over a given bias, top-2), and at
  config #3's refine plan (224 entries of a 10M-row arena).

The builds run in turns (forward, then backward) at each shape; the line
per (shape, build) is the mean of its two medians, beside the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as c  # noqa: E402
from cloudvectordb_tpu_torch.ops import _cuda, band, pq  # noqa: E402
from cloudvectordb_tpu_torch.ops import flat_topk as flat  # noqa: E402


def build(name: str, sources: list[Path], out: Path) -> dict[str, ctypes.CDLL]:
    """Each source built and bound as ops/_cuda.py binds library ``name``,
    by label (its position and file name)."""
    procs = {}
    for src in sources:
        lib = out / f"lib{name}_{len(procs)}.so"
        cmd = [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(_cuda._CSRC),
               "-o", str(lib), str(src)]
        procs[f"{len(procs)}:{src.name}"] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True))
    libs = {}
    for label, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{label}: nvcc failed\n{err}")
        dll = ctypes.CDLL(str(lib))
        print(f"[build] {label}: {'; '.join(c.ptxas_report(err))}", flush=True)
        for fn, (argtypes, restype) in _cuda._SIGNATURES[name].items():
            if not hasattr(dll, fn):  # an older source
                if fn == "cvdb_pq_scan_block_queries":  # one width: 32 queries a block
                    setattr(dll, fn, lambda *a: 32)
                continue
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = restype
        libs[label] = dll
    return libs


def pq_shapes(dev):
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
    # the opqpq10m.b4096 cell's plan: 320 entries of tile_q 64, k_cand 2050
    # over two pools of 1024 buckets with top-2
    cell_ct = (torch.randn((n_tiles, CELL_W, d), generator=g, device=dev)
               / d ** 0.5).to(torch.bfloat16)
    cell_local = torch.sort(torch.randint(0, CELL_W, (n_tiles, tile_n), generator=g,
                                          device=dev), dim=1)[0].to(torch.uint8).reshape(-1)
    cell_table = torch.randint(0, n_tiles, (c.B // 64, 320), generator=g, device=dev,
                               dtype=torch.int32)
    args = dict(codes_cm=codes, codebooks=cb, queries_sorted=q, tile_table=cell_table, k=2050,
                centroid_tiles=cell_ct, tile_n=tile_n, tile_q=64, l_buckets=0, n_pools=2,
                n_valid=n_tiles * tile_n - 100, row_major=True, local_ids=cell_local, top2=True)
    # held through exact f64 scores: 2050 candidates a query of random rows
    # hold near-ties that the two f32 orders rank either way
    yield (f"K5 cell tq64 p320 pools2 top2 W{CELL_W}", lambda a=args: pq.pq_tiles_topk(**a),
           lambda a=args: pq.pq_tiles_topk_reference(**a),
           c.pq_exact(codes, cell_local, cb, cell_ct, tile_n, q))
    del cell_ct, cell_local, args
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


def scan_shapes(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    n_tiles, tile_n = 6104, 2048
    db = torch.randint(-127, 128, (n_tiles * tile_n, c.D), generator=g, device=dev,
                       dtype=torch.int8)
    q = torch.randn((c.B, c.D), generator=g, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    q_bf = q.to(torch.bfloat16)
    q8, _ = flat.quantize_queries(q)
    table = torch.randint(0, n_tiles, (c.B // 32, 96), generator=g, device=dev,
                          dtype=torch.int32)
    n_valid = n_tiles * tile_n - 1000
    for label, qk, int8, top2 in (("hybrid", q_bf, "hybrid", False), ("int8", q8, True, False),
                                  ("hybrid top2", q_bf, "hybrid", True)):
        kw = dict(tile_n=tile_n, tile_q=32, int8=int8, n_valid=n_valid, top2=top2)
        yield (f"K3 {label} B{c.B} p96 tq32", lambda a=(qk, kw): band.tiles_topk(
            db, a[0], table, c.K, **a[1]), lambda a=(qk, kw): band.tiles_topk_reference(
            db, a[0], table, c.K, **a[1]))
    starts = torch.zeros(c.B // 256, dtype=torch.int32, device=dev)
    kw = dict(tile_n=tile_n, tile_q=256, int8=True, n_valid=n_valid)
    yield (f"K7 int8 B{c.B} tq256 band {n_tiles}",
           lambda: band.band_topk(db, q8, starts, c.K, n_tiles, **kw),
           lambda: band.band_topk_reference(db, q8, starts, c.K, n_tiles, **kw))


def flat_shapes(dev):
    """K2 at the flat cells' shapes: f32 l2 over SIFT-like integer rows (cell
    3), int8 (cell 4), f32 ip over unit rows at the encoder's width (cell
    6)."""
    x = c.sift_like(dev, c.SIFT_ROWS, c.SIFT_D, seed=1)
    qs = c.sift_like(dev, c.SIFT_Q, c.SIFT_D, seed=2)
    sq = (x * x).sum(dim=1)
    yield (f"K2 f32 l2 {c.SIFT_ROWS}x{c.SIFT_D} Q{c.SIFT_Q}",
           lambda: flat.flat_topk(x, qs, c.K, metric="l2", db_sqnorms=sq),
           lambda: flat.flat_topk_reference(x, qs, c.K, metric="l2", db_sqnorms=sq))
    del x, qs, sq
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    x8 = torch.randint(-127, 128, (1_000_000, c.D), generator=g, device=dev, dtype=torch.int8)
    q8 = torch.randint(-127, 128, (c.B, c.D), generator=g, device=dev, dtype=torch.int8)
    yield (f"K2 int8 1000000x{c.D} Q{c.B}", lambda: flat.flat_topk(x8, q8, c.K),
           lambda: flat.flat_topk_reference(x8, q8, c.K))
    del x8, q8
    x = torch.randn((c.N_PASSAGES, 384), generator=g, device=dev)
    x = x / x.norm(dim=1, keepdim=True)
    q = torch.randn((c.N_QUERIES, 384), generator=g, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    yield (f"K2 f32 ip {c.N_PASSAGES}x384 Q{c.N_QUERIES}", lambda: flat.flat_topk(x, q, c.K),
           lambda: flat.flat_topk_reference(x, q, c.K))


def resid_shapes(dev):
    """K1 at the residual path's plan and at config #3's refine plan, on a
    random arena: local ids rising through each tile's W = 36 lists (the
    12.5M-row index's window), each list's last eighth of rows past its
    valid_end."""
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    n_tiles, tile_n, w = 6104, 2048, 36
    db = torch.randint(-127, 128, (n_tiles * tile_n, c.D), generator=g, device=dev,
                       dtype=torch.int8)
    local = torch.sort(torch.randint(0, w, (n_tiles, tile_n), generator=g, device=dev),
                       dim=1)[0]
    tile_row = torch.arange(n_tiles, device=dev)[:, None] * tile_n
    first = torch.full((n_tiles, w), tile_n, device=dev).scatter_reduce(
        1, local, torch.arange(tile_n, device=dev).expand(n_tiles, -1), "amin")
    count = torch.zeros((n_tiles, w), dtype=torch.long, device=dev).scatter_add(
        1, local, torch.ones_like(local))
    valid_end = (tile_row + first + count - count // 8).to(torch.int32)
    ct = (torch.randn((n_tiles, w, c.D), generator=g, device=dev) / c.D ** 0.5).to(torch.bfloat16)
    q = torch.randn((c.B, c.D), generator=g, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    mask = (torch.rand(n_tiles * tile_n, generator=g, device=dev) < 0.1).to(torch.int8)
    bias = -torch.rand(n_tiles * tile_n, generator=g, device=dev)
    variants = {"": {}, " precise": dict(int8_q=False), " masked": dict(row_mask=mask),
                " l2": dict(l2=True, row_bias=bias), " top2": dict(top2=True)}
    for p in (96, 224):
        table = torch.randint(0, n_tiles, (c.B // 32, p), generator=g, device=dev,
                              dtype=torch.int32)
        for label, kw in variants.items() if p == 96 else [("", {})]:
            args = dict(db_resid=db, local_ids=local.to(torch.uint8).reshape(-1),
                        centroid_tiles=ct, resid_scale=0.00114, queries_sorted=q,
                        tile_table=table, valid_end=valid_end, tile_n=tile_n, tile_q=32, **kw)
            yield (f"K1{label} B{c.B} p{p} tq32", lambda a=args: band.tiles_topk_resid(**a, k=c.K),
                   lambda a=args: band.tiles_topk_resid_reference(**a, k=c.K))


#: centroid rows a tile of the opqpq10m.b4096 cell's index (its tile window)
CELL_W = 4

SHAPES = {"pq_scan": pq_shapes,
          "tiles_scan": lambda dev: itertools.chain(scan_shapes(dev), flat_shapes(dev)),
          "tiles_resid": resid_shapes}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default="pq_scan", choices=sorted(SHAPES))
    ap.add_argument("--only", default="", help="time only the shapes whose name starts so")
    ap.add_argument("variants", nargs="*", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_pq_scan_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    sources = [_cuda._CSRC / f"{args.source}.cu", *args.variants]
    card = c.card_line()
    print(f"[env] card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(args.source, sources, Path(tmp))
        variants = list(libs)
        for name, kernel, plain, *exact in SHAPES[args.source](dev):
            if not name.startswith(args.only):
                continue
            ms = {v: [] for v in variants}
            ref = plain()  # the plain version once a shape
            for order in (variants, variants[::-1]):
                for v in order:
                    _cuda._libs[args.source] = libs[v]
                    if not ms[v]:
                        try:
                            c.compare(f"{name} {v}", kernel, lambda: ref,
                                      exact=exact[0] if exact else None)
                        except AssertionError as e:
                            print(f"[ab] {name} {v}: FAILED the hold: {e}", flush=True)
                    ms[v].append(c.time_ms(kernel, 3))
            for v in variants:
                print(f"[ab] {name} {v}: {sum(ms[v]) / 2:.3f} ms (medians "
                      f"{', '.join(f'{x:.3f}' for x in ms[v])}); {card}", flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
