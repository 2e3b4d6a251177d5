#!/usr/bin/env python3
"""Times the top-1 scans of one checkout of this repository on one GPU: K1
at the 12.5M x 768 residual index's (96, 32) plan, K3 hybrid and int8 at
the whole-row index's, K7 at its band plan, K2 f32 l2 and int8 at the flat
cells' shapes (chip_smoke.py's corpus, queries and helpers, from that
checkout), and K3 hybrid on rows too deep for resident queries (the
CUDA-core body: random int8 rows, 262,144 x 3072, 16 steps a query tile of
32, B 4096). Prints one line: ``GUARD <root> {kernel: ms}``.

Run from any directory, a checkout's root as the argument::

    python3 scripts/torch_scan_checkout_times.py /path/to/checkout

To compare two commits on one card, unpack the other with ``git archive``
into a gitignored directory and run the two in turns in one call (parent,
change, change, parent), each in a process of its own.
"""
from __future__ import annotations

import json
import sys


def times(root: str) -> dict:
    """{kernel: median ms} of the checkout at ``root`` (its package and
    chip_smoke.py imported from there)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as c
    from cloudvectordb_tpu_torch.index.flat import FlatIndex
    from cloudvectordb_tpu_torch.ops import _cuda, band
    from cloudvectordb_tpu_torch.ops import flat_topk as flat

    if not _cuda.__file__.startswith(root):
        raise RuntimeError(f"imported {_cuda.__file__}, not the checkout at {root}")
    dev = torch.device("cuda", 0)
    _cuda.build(["tiles_resid", "tiles_scan"])
    chunk_fn = c.make_corpus(dev, c.CHUNK)
    q = c.make_queries(chunk_fn, dev, c.B)
    out = {"K3 hybrid D3072": deep_k3(dev, band, c)}
    idx, _ = c.build_index(dev, chunk_fn, c.N_ROWS // c.CHUNK, True)
    a = c.k1_plan(idx, q, 96, 32)
    out["K1"] = c.time_ms(lambda: band.tiles_topk_resid(**a, k=c.K), 20)
    del idx, a
    torch.cuda.empty_cache()
    idx, _ = c.build_index(dev, chunk_fn, c.N_ROWS // c.CHUNK, False)
    st = idx._device_state()
    q_s, table = c.k3_plan(idx, q, 96, 32)
    q8, _ = flat.quantize_queries(q_s)
    for name, qk, int8 in (("K3 hybrid", q_s.to(torch.bfloat16), "hybrid"),
                           ("K3 int8", q8, True)):
        kw = dict(tile_n=idx.tile_n, tile_q=32, int8=int8, n_valid=idx._n)
        out[name] = c.time_ms(lambda: band.tiles_topk(st["payload"], qk, table, c.K, **kw), 20)
    q8b, starts, band_tiles = c.k7_plan(idx, q)
    kw7 = dict(tile_n=idx.tile_n, tile_q=idx.tile_q, int8=True, n_valid=idx._n)
    out["K7"] = c.time_ms(
        lambda: band.band_topk(st["payload"], q8b, starts, c.K, band_tiles, **kw7), 5)
    del idx, st
    torch.cuda.empty_cache()
    x = c.sift_like(dev, c.SIFT_ROWS, c.SIFT_D, seed=1)
    qs = c.sift_like(dev, c.SIFT_Q, c.SIFT_D, seed=2)
    sq = (x * x).sum(dim=1)
    out["K2 f32 l2"] = c.time_ms(
        lambda: flat.flat_topk(x, qs, c.K, metric="l2", db_sqnorms=sq), 10)
    del x, qs, sq
    flat8 = FlatIndex.build(torch.cat([chunk_fn(0), chunk_fn(1)]), metric="ip", dtype="int8",
                            device=dev)
    q8f, _ = flat.quantize_queries(q)
    out["K2 int8"] = c.time_ms(lambda: flat.flat_topk(flat8._vecs, q8f, c.K), 10)
    return out


def deep_k3(dev, band, c) -> float:
    """Median ms of top-1 K3 with bf16 queries over int8 rows at D 3072."""
    import torch

    n, d, tile_n, tq, steps = 262_144, 3072, 2048, 32, 16
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    rows = torch.randint(-127, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
    q = torch.randn((c.B, d), generator=g, device=dev).to(torch.bfloat16)
    table = torch.randint(0, n // tile_n, (c.B // tq, steps), generator=g, device=dev,
                          dtype=torch.int32)
    kw = dict(tile_n=tile_n, tile_q=tq, int8="hybrid", n_valid=n)
    return c.time_ms(lambda: band.tiles_topk(rows, q, table, c.K, **kw), 5)


def main() -> int:
    root = sys.argv[1]
    print("GUARD", root, json.dumps(times(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
