"""Headline op-point sweep (counterpart of scripts/sweep_headline.py): the
12.5M x 768 residual-int8 tiles index (BASELINE config #4's share of a
card, nlist 4096) over (tile_n, tile_q, p_tiles): is there QPS above the
p 640 / tile_q 256 / tile_n 2048 point at recall >= 0.97?

Usage: python scripts/torch_sweep_headline.py [N_millions=12.5]
Env:   SWEEP_TILE_N="2048,4096", SWEEP_TQ="128,256", SWEEP_P="0.7,1.0,1.4"
       (fractions of the equal-coverage p for that tile_n)

For each tile_n the index is built anew (``build_device_streaming``) and
every (tile_q, p) row served through the public ``search_device``, as the
reference's. p is the reference's: its coverage of the blessed point
(640 of 6104 tiles) times the fraction, in multiples of 32, at least 32.
A row's recall@10 is against the exact f32 top-10 of the first 512 of the
4096 queries; its QPS is 4096 queries a call over the fenced host clock of
8 back-to-back calls, after two warm-up calls, each call on queries moved
by a small constant as the reference's. K1 serves every call. A row that
fails fails the run. Ends with one JSON line of the rows.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cloudvectordb_tpu_torch.eval import harness  # noqa: E402
from cloudvectordb_tpu_torch.eval.recall import recall_at_k  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex  # noqa: E402
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

D, K, B = 768, 10, 4096
CHUNK = 500_000
NQ_GT = 512
NLIST = 4096
REPS = 8
#: the coverage of the blessed point, 640 of 6104 tiles
REF_COV = 640.0 / 6104.0


def sweep_p(n_tiles: int, frac: float) -> int:
    """p_tiles of a row: the blessed coverage times ``frac``, down to a
    multiple of 32, at least 32 (the reference's)."""
    return max(32, int(REF_COV * n_tiles * frac) // 32 * 32)


def main(argv=None, device="cuda") -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = as_device(device)
    n = int(float(argv[0]) * 1e6) if argv else 12_500_000
    n_chunks = n // CHUNK
    tile_ns = [int(x) for x in os.environ.get("SWEEP_TILE_N", "2048,4096").split(",")]
    tqs = [int(x) for x in os.environ.get("SWEEP_TQ", "128,256").split(",")]
    p_fracs = [float(x) for x in os.environ.get("SWEEP_P", "0.7,1.0,1.4").split(",")]
    card = harness.card_line(dev)
    print(f"sweep_headline: N={n_chunks * CHUNK} D={D} nlist={NLIST} tile_n {tile_ns} "
          f"tile_q {tqs} p fractions {p_fracs}; {card}", flush=True)
    chunk_fn = harness.latent_corpus(dev, D, [CHUNK] * n_chunks)
    queries = harness.noisy_queries(chunk_fn(0), B)
    harness.reset_launches()

    (_, gt), gt_ms = harness.host_ms(
        lambda: harness.exact_topk_chunks(chunk_fn, n_chunks, queries[:NQ_GT], K), dev)
    gt = gt.cpu().numpy()
    print(f"[gt] {gt_ms / 1e3:.0f} s", flush=True)

    rows, builds = [], []
    for tile_n in tile_ns:
        t0 = time.perf_counter()
        idx = BandIVFIndex.build_device_streaming(chunk_fn, n_chunks, nlist=NLIST,
                                                  kmeans_iters=10, residual=True, tile_n=tile_n,
                                                  device=dev)
        harness.sync(dev)
        build_s = time.perf_counter() - t0
        n_tiles = idx._tune_n_tiles()
        builds.append({"tile_n": tile_n, "build_s": build_s, "n_tiles": n_tiles})
        print(f"[build] tile_n={tile_n}: {build_s:.0f} s, n_tiles={n_tiles}", flush=True)
        for tq in tqs:
            for frac in p_fracs:
                p = sweep_p(n_tiles, frac)

                def run(noise, p=p, tq=tq):
                    return idx.search_device(queries + noise, K, p_tiles=p, tile_q=tq)

                _, g = run(0.0)
                r = recall_at_k(g[:NQ_GT].cpu().numpy(), gt)
                for it in range(2):
                    run(0.5 + 1e-4 * it)
                _, ms = harness.host_ms(
                    lambda: [run(1e-4 * (it + 1)) for it in range(REPS)], dev)
                qps = B * REPS / (ms / 1e3)
                rows.append({"tile_n": tile_n, "tq": tq, "p": p, "share": p / n_tiles,
                             "recall": r, "ms": ms / REPS, "qps": qps})
                print(f"  tile_n={tile_n} tq={tq:4d} p={p:5d} ({p / n_tiles:5.1%}): "
                      f"recall@10={r:.4f}  {qps:9.0f} qps/card", flush=True)
        idx = None  # free the arena before the next build
    return harness.emit({"script": "sweep_headline", "card": card, "N": n_chunks * CHUNK,
                         "nlist": NLIST, "builds": builds, "rows": rows,
                         "launches": harness.launches()})


if __name__ == "__main__":
    main()
