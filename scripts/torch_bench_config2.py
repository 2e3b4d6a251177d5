"""BASELINE config #2: 1M passages x 384-d (MiniLM-L6 width), IVF-Flat nlist
4096, the nprobe sweep: recall against QPS (counterpart of
scripts/bench_config2.py).

Usage: python scripts/torch_bench_config2.py [N=1000000] [nprobes=1,4,8,16,32,64]

The embeddings follow the headline bench's process (32-d latent, 256 soft
clusters, unit norm) at 384-d. Two paths on the same data:

  - IVF-Flat, the literal config #2 structure (exact IVF semantics, recall
    to 1 as nprobe reaches nlist), through ``eval/sweep.py::nprobe_sweep``
    (host clock over ``search()``) and its operating point at 0.95;
  - the residual-int8 tiles index (nlist 1024; K1) at p_tiles 32, 64 and
    128 over a B=4096 batch (the 512 queries repeated), device QPS from
    CUDA events around ``search_device``.

Recall is against the exact f32 top-10. Ends with one JSON line.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from cloudvectordb_tpu_torch.eval import harness  # noqa: E402
from cloudvectordb_tpu_torch.eval.recall import recall_at_k  # noqa: E402
from cloudvectordb_tpu_torch.eval.sweep import nprobe_sweep, operating_point  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_flat import IVFFlatIndex  # noqa: E402
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

D, K = 384, 10
NLIST, TILES_NLIST = 4096, 1024
NQ, B = 512, 4096
P_TILES = (32, 64, 128)
REPS = 16


def main(argv=None, device="cuda") -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = as_device(device)
    n = int(float(argv[0])) if argv else 1_000_000
    nprobes = tuple(int(x) for x in (argv[1].split(",") if len(argv) > 1
                                     else ["1", "4", "8", "16", "32", "64"]))
    card = harness.card_line(dev)
    print(f"config#2: N={n} D={D} nlist={NLIST} nprobes={nprobes}; {card}", flush=True)

    db = harness.latent_corpus(dev, D, [n])(0)
    q = harness.noisy_queries(db, NQ)
    gt = harness.exact_topk_chunks(lambda i: db, 1, q, K)[1].cpu().numpy()
    q_np = q.cpu().numpy()
    print("data + exact gt ready", flush=True)
    harness.reset_launches()

    # --- literal config #2: IVF-Flat, nprobe sweep ---------------------------
    t0 = time.perf_counter()
    ivf = IVFFlatIndex.build(db, NLIST, metric="ip", kmeans_iters=10, dtype="float32",
                             device=dev)
    harness.sync(dev)
    ivf_build_s = time.perf_counter() - t0
    print(f"IVF-Flat build: {ivf_build_s:.0f} s", flush=True)
    rows = nprobe_sweep(ivf, None, q_np, k=K, nprobes=nprobes, batch=256, gt_ids=gt)
    print("\nIVF-Flat probe-scan (exact IVF semantics):", flush=True)
    for r in rows:
        print(f"  nprobe={r['nprobe']:4d}  recall@10={r['recall']:.4f}  "
              f"{r['qps']:8.0f} qps  {r['latency_ms']:.1f} ms/batch", flush=True)
    op = operating_point(rows, 0.95)
    if op:
        print(f"  operating point (recall≥0.95): nprobe={op['nprobe']} at {op['qps']:.0f} qps",
              flush=True)
    del ivf

    # --- the serving path on the same data: residual-int8 tiles ---------------
    t0 = time.perf_counter()
    idx = BandIVFIndex.build(db, nlist=TILES_NLIST, dtype="int8", residual=True,
                             kmeans_iters=10, device=dev)
    harness.sync(dev)
    tiles_build_s = time.perf_counter() - t0
    print(f"\nresid-int8 tiles build: {tiles_build_s:.0f} s", flush=True)
    n_tiles = idx._tune_n_tiles()
    qb = q.repeat(B // NQ, 1)
    tiles = []
    for p_tiles in P_TILES:
        p = min(p_tiles, n_tiles)

        def run(i, p=p):
            return idx.search_device(qb + 1e-4 * (i + 1), K, p_tiles=p, tile_q=idx.tile_q)

        _, g = idx.search_device(qb, K, p_tiles=p, tile_q=idx.tile_q)
        r = recall_at_k(g[:NQ].cpu().numpy(), gt)
        run(-1)
        ms = float(np.median(harness.device_ms(run, dev, REPS)))
        tiles.append({"p_tiles": p, "share": p / n_tiles, "recall": r, "ms": ms,
                      "qps": B / (ms / 1e3)})
        print(f"  p_tiles={p:4d} ({p / n_tiles:5.1%}): recall@10={r:.4f}  "
              f"{B / (ms / 1e3):9.0f} qps (median of {REPS}: {ms:.3f} ms a batch)", flush=True)
    return harness.emit({"script": "bench_config2", "card": card, "N": n, "D": D,
                         "nlist": NLIST, "ivf_build_s": ivf_build_s, "ivf_flat": rows,
                         "operating_point": op, "tiles_nlist": TILES_NLIST,
                         "tiles_build_s": tiles_build_s, "n_tiles": n_tiles, "B": B,
                         "tiles": tiles, "launches": harness.launches()})


if __name__ == "__main__":
    main()
