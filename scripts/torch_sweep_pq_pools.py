"""K5's candidate pools x refine depth on the PQ-tiles index (counterpart
of scripts/sweep_pq_pools.py): OPQ + IVF-PQ (m 64, nbits 8, residual, int8
refine, tile_n 1024, tile_q 128) at 2M x 768, ten (n_pools,
refine_factor, top2) rows at one p_tiles.

Usage: python scripts/torch_sweep_pq_pools.py [N_millions=2] [nlist=2048] [p_tiles=0]

A fixed refine_factor with more pools keeps the total slot count (the
buckets shrink to k_cand / n_pools), so per-slot competition stays; the
rows that raise refine_factor with the pools test shadowing recovery, and
the top-2 rows keep each bucket's best two rows at the same tile traffic
(the matching top-1 row with twice the pools is the equal-slot control).
The quantizers (OPQ, coarse k-means, PQ codebooks) are trained on the
first chunk's 131,072-row sample apart from the build and passed in, as
scripts/torch_bench_build_budget.py does; each stage is timed. p_tiles 0
takes the reference's 10.5% of the tiles, at least 8. A row's recall@10 is
that of the first 512 queries of a ``search()`` of the whole batch of 4096
against their exact f32 top-10 (the reference searches the 512 alone: a
smaller batch spans more lists a query group, so its recall is not the
timed op point's; ROADMAP.md queue 3); its QPS is 4096 queries over the
mean host clock of 8 ``search()`` calls on the whole batch rolled by one
row each time (the numpy return is the fence). K5 and the int8 rescore
serve every row. A row that fails fails the run. Ends with one JSON line
of the rows.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from cloudvectordb_tpu_torch.eval import harness  # noqa: E402
from cloudvectordb_tpu_torch.eval.recall import recall_at_k  # noqa: E402
from cloudvectordb_tpu_torch.index import ivf_band  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex  # noqa: E402
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

D, K, B = 768, 10, 4096
CHUNK = 250_000
NQ_GT = 512
M, NBITS = 64, 8
TILE_N, TILE_Q = 1024, 128
TRAIN_SAMPLE = 131_072
KMEANS_ITERS = 15
REPS = 8
#: (n_pools, refine_factor, top2), the reference's rows (sweep_pq_pools.py:102-106)
ROWS = ((1, 16, False), (1, 102, False), (2, 102, False), (1, 102, True), (2, 102, True),
        (4, 102, False), (4, 409, False), (2, 409, True), (4, 409, True), (8, 409, False))


def sweep_p(n_tiles: int, p_tiles_arg: int) -> int:
    """The sweep's p_tiles: the argument, or 10.5% of the tiles rounded,
    at least 8 (the reference's)."""
    return p_tiles_arg or max(8, round(0.105 * n_tiles))


def train_quantizers(dev, sample, nlist: int) -> tuple:
    """OPQ, coarse k-means and PQ codebooks on ``sample``, each timed
    (fenced host clock): (the empty trained index, {stage: seconds})."""
    proto = BandIVFPQIndex(D, nlist, m=M, nbits=NBITS, refine="int8",
                           kmeans_iters=KMEANS_ITERS, tile_n=TILE_N, tile_q=TILE_Q, device=dev)
    _, opq_ms = harness.host_ms(lambda: proto._train_opq(sample), dev)
    tr = proto._rotate(sample)
    cents, km_ms = harness.host_ms(lambda: ivf_band.train_ordered_centroids(
        tr, nlist, TRAIN_SAMPLE, proto.kmeans_iters, proto.seed), dev)
    _, pq_ms = harness.host_ms(lambda: proto._train_quantizers(tr, cents, None), dev)
    return proto, {"opq_s": opq_ms / 1e3, "kmeans_s": km_ms / 1e3, "pq_s": pq_ms / 1e3}


def main(argv=None, device="cuda") -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = as_device(device)
    n = int(float(argv[0]) * 1e6) if argv else 2_000_000
    nlist = int(argv[1]) if len(argv) > 1 else 2048
    p_tiles_arg = int(argv[2]) if len(argv) > 2 else 0
    card = harness.card_line(dev)
    print(f"sweep_pq_pools: N={n} D={D} m={M} nbits={NBITS} OPQ refine=int8 nlist={nlist}; "
          f"{card}", flush=True)
    sizes = harness.chunk_sizes(n, CHUNK)
    chunk_fn = harness.latent_corpus(dev, D, sizes)
    queries = harness.noisy_queries(chunk_fn(0), B)
    harness.reset_launches()

    (_, gt), gt_ms = harness.host_ms(
        lambda: harness.exact_topk_chunks(chunk_fn, len(sizes), queries[:NQ_GT], K), dev)
    gt = gt.cpu().numpy()
    print(f"gt {gt_ms / 1e3:.0f}s", flush=True)

    sample = chunk_fn(0)[:TRAIN_SAMPLE]
    proto, train = train_quantizers(dev, sample, nlist)
    sample = None
    print(f"train {sum(train.values()):.1f}s: OPQ {train['opq_s']:.1f} s, coarse k-means "
          f"{train['kmeans_s']:.1f} s, PQ codebooks {train['pq_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    idx = BandIVFPQIndex.build_device_streaming(
        chunk_fn, len(sizes), nlist=nlist, m=M, nbits=NBITS, refine="int8",
        kmeans_iters=KMEANS_ITERS, tile_n=TILE_N, tile_q=TILE_Q, train_sample=TRAIN_SAMPLE,
        opq_matrix=proto.opq_matrix, centroids=proto.centroids, codebooks=proto.codebooks,
        device=dev)
    harness.sync(dev)
    build_s = time.perf_counter() - t0
    print(f"build {build_s:.0f}s n={idx._n}", flush=True)
    n_tiles = idx._n_pad_rows // idx.tile_n
    p_tiles = sweep_p(n_tiles, p_tiles_arg)
    qh = queries.cpu().numpy()

    rows = []
    for n_pools, rf, top2 in ROWS:
        kw = dict(p_tiles=p_tiles, refine_factor=rf, n_pools=n_pools, top2=top2)
        _, f = idx.search(qh, K, **kw)
        r = recall_at_k(f[:NQ_GT], gt)
        ts = time.perf_counter()
        for it in range(REPS):
            s2, _ = idx.search(np.roll(qh, it + 1, axis=0), K, **kw)
            _ = float(np.asarray(s2).sum())
        dt = (time.perf_counter() - ts) / REPS
        rows.append({"n_pools": n_pools, "refine_factor": rf, "top2": top2, "recall": r,
                     "ms": dt * 1e3, "qps": B / dt})
        print(f"pools={n_pools} rf={rf} top2={int(top2)}: recall@10 {r:.4f}  "
              f"{B / dt:,.0f} qps  p_tiles={p_tiles}/{n_tiles}", flush=True)
    return harness.emit({"script": "sweep_pq_pools", "card": card, "N": n, "nlist": nlist,
                         "p_tiles": p_tiles, "n_tiles": n_tiles, "gt_s": gt_ms / 1e3,
                         "train": train, "build_s": build_s, "rows": rows,
                         "launches": harness.launches()})


if __name__ == "__main__":
    main()
