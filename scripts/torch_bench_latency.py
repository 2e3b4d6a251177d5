"""Small-batch latency of the residual-int8 tiles index (counterpart of
scripts/bench_latency.py): p50 and p99 of the per-call latency at B in
{1, 8, 64} on the 12.5M x 768 index (nlist 4096), the serving story a
B=4096 throughput figure does not cover. K1 serves every call.

Usage: python scripts/torch_bench_latency.py [N_millions=12.5]
Env:   LAT_BATCHES="1,8,64", LAT_REPS=30, BENCH_NLIST=4096

The op point per batch size is the reference's: tile_q = max(8, B) (one
query group: the tile table is the batch's union span) and the span-aware
auto p_tiles. A call's latency is the host clock over ``search()``, whose
numpy return is the fence; its device time is CUDA events around
``search_device`` on queries already on the card. The self-hit@1 of 256
corpus rows at the smallest batch's op point must reach SELF_HIT_FLOOR.
Ends with one JSON line of the table's numbers.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from cloudvectordb_tpu_torch.eval import harness  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex  # noqa: E402
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

D, K = 768, 10
CHUNK = 500_000
#: the query pool: noisy copies of the first POOL rows of chunk 0
POOL = 4096
SELF_HIT_ROWS = 256
#: the reference read 1.000 at the B=1 op point (ROUND3.md:16)
SELF_HIT_FLOOR = 0.99


def main(argv=None, device="cuda") -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = as_device(device)
    n = int(float(argv[0]) * 1e6) if argv else 12_500_000
    nlist = int(os.environ.get("BENCH_NLIST", 4096))
    batches = [int(b) for b in os.environ.get("LAT_BATCHES", "1,8,64").split(",")]
    reps = int(os.environ.get("LAT_REPS", "30"))
    card = harness.card_line(dev)
    sizes = harness.chunk_sizes(n, CHUNK)
    chunk_fn = harness.latent_corpus(dev, D, sizes)

    harness.reset_launches()
    t0 = time.perf_counter()
    idx = BandIVFIndex.build_device_streaming(chunk_fn, len(sizes), nlist=nlist, kmeans_iters=10,
                                              residual=True, device=dev)
    harness.sync(dev)
    build_s = time.perf_counter() - t0
    print(f"[build] {n / 1e6:.1f}M rows in {build_s:.0f} s", flush=True)
    n_tiles = idx._tune_n_tiles()

    # the first POOL rows of chunk 0 are global ids 0..POOL-1
    base = chunk_fn(0)[:POOL]
    qdev = harness.noisy_queries(base, POOL)
    qpool = qdev.cpu().numpy()
    span = min(4000, POOL - max(batches))

    print(f"{card}", flush=True)
    print(f"{'B':>4} {'tq':>4} {'p':>5}  {'p50':>9} {'p99':>9} {'dev/call':>9}  {'qps@dev':>8}",
          flush=True)
    rows = []
    for b in batches:
        tq = max(8, b)
        p = idx._auto_p_tiles(b, 32, n_tiles, tile_q=tq)
        idx.search(qpool[:b], K, p_tiles=p, tile_q=tq)  # warm
        lats = []
        for it in range(reps):
            q = qpool[(it * b) % span:(it * b) % span + b]
            harness.sync(dev)
            t1 = time.perf_counter()
            idx.search(q, K, p_tiles=p, tile_q=tq)  # numpy outputs: the fence
            lats.append((time.perf_counter() - t1) * 1e3)
        p50, p99 = harness.p50_p99(lats)

        def step(i, b=b, tq=tq, p=p):
            s = (i * b) % span
            idx.search_device(qdev[s:s + b], K, p_tiles=p, tile_q=tq)

        step(0)
        dev_ms = float(np.median(harness.device_ms(step, dev, reps)))
        row = {"B": b, "tq": tq, "p": p, "p50_ms": p50, "p99_ms": p99, "dev_ms": dev_ms,
               "qps_dev": b / (dev_ms / 1e3)}
        rows.append(row)
        print(f"{b:>4} {tq:>4} {p:>5}  {p50:8.3f}ms {p99:8.3f}ms {dev_ms:8.3f}ms  "
              f"{row['qps_dev']:8.0f}", flush=True)

    # recall sanity at the smallest batch's op point: self-hit@1 of corpus rows
    b0 = max(1, batches[0])
    qs = base[:SELF_HIT_ROWS].cpu().numpy()
    tq = max(8, batches[0])
    p = idx._auto_p_tiles(batches[0], 32, n_tiles, tile_q=tq)
    hits = 0
    for i in range(0, qs.shape[0], b0):
        _, f = idx.search(qs[i:i + b0], 1, p_tiles=p, tile_q=tq)
        hits += int((f[:, 0] == np.arange(i, i + f.shape[0])).sum())
    self_hit = hits / qs.shape[0]
    print(f"[sanity] self-hit@1 on {qs.shape[0]} DB rows at B={batches[0]} op point: "
          f"{self_hit:.3f}", flush=True)
    if self_hit < SELF_HIT_FLOOR:
        raise AssertionError(f"self-hit@1 {self_hit:.3f} < {SELF_HIT_FLOOR}")
    return harness.emit({"script": "bench_latency", "card": card, "N": n, "nlist": nlist,
                         "reps": reps, "build_s": build_s, "n_tiles": n_tiles, "rows": rows,
                         "self_hit": self_hit, "launches": harness.launches()})


if __name__ == "__main__":
    main()
