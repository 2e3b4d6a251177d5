"""Filtered search at headline scale (counterpart of scripts/bench_filtered.py):
the 12.5M x 768 residual-int8 tiles index at the headline op point (p 448,
tq 128), recall@10 against the filter-restricted exact top-10 and device
QPS across selectivities, beside the unfiltered QPS at the same op point.

Usage: python scripts/torch_bench_filtered.py
Env:   N_ROWS=12500000, SELS="0.5,0.1,0.01", BENCH_P=448, BENCH_TQ=128

Each selectivity draws a bool mask by global id from
``np.random.default_rng(42)`` (one draw a selectivity, in order) and serves
``search_device(where=)``: K1 masked. At selectivity <= 0.05 it also runs
p x 2 and p x 4 (the planner is selectivity-blind; more tiles recover
recall). The run fails if any filled slot of the batch holds a disallowed
id. Recall is scored against the exact restricted top-10 of the first 512
queries (``harness.exact_topk_chunks(allow=)``). The reference's own ground
truth is computed and scored beside it: each 500,000-row chunk's exact
top-64, post-filtered, merged (``merged_chunk_gt``). At 1% a chunk's top-64
holds 0.64 allowed rows on average, so that recipe misses true neighbours;
its overlap with the exact one and the share of queries it misses are
reported. QPS is 4096 queries a call over the fenced host clock of 8 calls
after 2 warm ones, on queries moved by a small constant. Ends with one JSON
line.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cloudvectordb_tpu_torch.eval import harness  # noqa: E402
from cloudvectordb_tpu_torch.eval.recall import recall_at_k  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex  # noqa: E402
from cloudvectordb_tpu_torch.ops.topk import NEG_INF, merge_topk  # noqa: E402
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

D, K, B = 768, 10, 4096
CHUNK = 500_000
NLIST = 4096
NQ_GT = 512
GT_PER_CHUNK = 64
REPS = 8


def chunk_tops(chunk_fn, n_chunks: int, q: torch.Tensor, m: int) -> list:
    """Each chunk's exact top-m (scores, global ids): the reference's
    per-chunk ``tiled_topk``, independent of the filter."""
    out, base = [], 0
    for ci in range(n_chunks):
        x = chunk_fn(ci)
        v, i = harness.exact_topk_chunks(lambda _, x=x: x, 1, q, m)
        out.append((v, i + base))
        base += x.shape[0]
    return out


def merged_chunk_gt(tops: list, allow: torch.Tensor, k: int) -> torch.Tensor:
    """The reference's filtered ground truth (bench_filtered.py:119-128):
    each chunk's top-m post-filtered (disallowed rows to -inf), merged into
    a running top-k that starts at (-inf, 0), earlier entries winning ties.
    Not exact where a chunk's top-m holds fewer allowed rows than its share
    of the true top-k."""
    v0 = tops[0][0]
    best = (torch.full((v0.shape[0], k), NEG_INF, device=v0.device),
            torch.zeros((v0.shape[0], k), dtype=torch.int64, device=v0.device))
    for v, i in tops:
        best = merge_topk(*best, torch.where(allow[i], v, NEG_INF), i, k)
    return best[1]


def miss_share(found: np.ndarray, gt: np.ndarray) -> float:
    """Share of queries whose ``found`` lacks at least one id of ``gt``."""
    return float(np.mean([not set(t.tolist()) <= set(f.tolist()) for f, t in zip(found, gt)]))


def main(argv=None, device="cuda") -> dict:
    dev = as_device(device)
    n = int(os.environ.get("N_ROWS", 12_500_000))
    p_tiles = int(os.environ.get("BENCH_P", 448))
    tile_q = int(os.environ.get("BENCH_TQ", 128))
    sels = [float(s) for s in os.environ.get("SELS", "0.5,0.1,0.01").split(",")]
    n_chunks = n // CHUNK
    n = n_chunks * CHUNK
    card = harness.card_line(dev)
    chunk_fn = harness.latent_corpus(dev, D, [CHUNK] * n_chunks)
    q = harness.noisy_queries(chunk_fn(0), B)
    harness.reset_launches()

    print(f"build: {n}x{D} residual-int8, nlist={NLIST}; {card}", flush=True)
    t0 = time.perf_counter()
    idx = BandIVFIndex.build_device_streaming(chunk_fn, n_chunks, nlist=NLIST, kmeans_iters=10,
                                              residual=True, device=dev)
    harness.sync(dev)
    build_s = time.perf_counter() - t0
    print(f"build {build_s:.0f}s", flush=True)

    def fenced_qps(run) -> float:
        for it in range(2):
            run(0.5 + 1e-4 * it)
        _, ms = harness.host_ms(lambda: [run(1e-4 * (it + 1)) for it in range(REPS)], dev)
        return B * REPS / (ms / 1e3)

    def served(run, flt, gt, gt_ref) -> dict:
        """One filtered op point: its recalls against both ground truths,
        the allow check over every filled slot of the batch, its QPS."""
        v, f = run(0.0)
        filled = (v > NEG_INF).cpu().numpy()
        f_np = f.cpu().numpy()
        bad = int((~flt.allowed_np(f_np[filled])).sum())
        if bad:
            raise AssertionError(f"{bad} filled slots hold a disallowed id")
        found = f_np[:NQ_GT]
        return {"recall": recall_at_k(found, gt), "recall_reference_gt": recall_at_k(found, gt_ref),
                "qps": fenced_qps(run)}

    rng = np.random.default_rng(42)
    idx.search_device(q, K, p_tiles=p_tiles, tile_q=tile_q)  # the unfiltered op point, warm
    t0 = time.perf_counter()
    tops = chunk_tops(chunk_fn, n_chunks, q[:NQ_GT], GT_PER_CHUNK)
    harness.sync(dev)
    print(f"[gt] per-chunk top-{GT_PER_CHUNK}: {time.perf_counter() - t0:.0f} s", flush=True)
    rows = []
    for sel in sels:
        mask = rng.random(n) < sel
        flt = idx.make_filter(mask)
        allow = torch.as_tensor(mask, device=dev)
        t0 = time.perf_counter()
        _, gt = harness.exact_topk_chunks(chunk_fn, n_chunks, q[:NQ_GT], K, allow=allow)
        gt = gt.cpu().numpy()
        gt_ref = merged_chunk_gt(tops, allow, K).cpu().numpy()
        gt_s = time.perf_counter() - t0
        row = {"sel": sel, "p": p_tiles, "tq": tile_q, "gt_s": gt_s,
               "reference_gt_overlap": recall_at_k(gt_ref, gt),
               "reference_gt_miss_share": miss_share(gt_ref, gt)}

        def run(noise, flt=flt, p=p_tiles):
            return idx.search_device(q + noise, K, p_tiles=p, tile_q=tile_q, where=flt)

        row.update(served(run, flt, gt, gt_ref))
        print(f"sel={sel:5.2f}  recall@10={row['recall']:.4f}  qps={row['qps']:,.0f}  "
              f"all_allowed=True  p={p_tiles} tq={tile_q}  (the reference's merged ground "
              f"truth: recall {row['recall_reference_gt']:.4f}, overlap with exact "
              f"{row['reference_gt_overlap']:.4f}, {row['reference_gt_miss_share']:.1%} of "
              f"queries missing a true neighbour)", flush=True)
        row["more_tiles"] = []
        if sel <= 0.05:
            # selectivity-blind planning: the p_tiles knob recovers recall
            for p2 in (p_tiles * 2, p_tiles * 4):
                def run2(noise, flt=flt, p=p2):
                    return idx.search_device(q + noise, K, p_tiles=p, tile_q=tile_q, where=flt)

                r2 = {"p": p2, **served(run2, flt, gt, gt_ref)}
                row["more_tiles"].append(r2)
                print(f"       p={p2}: recall@10={r2['recall']:.4f}  qps={r2['qps']:,.0f}",
                      flush=True)
        rows.append(row)

    def run_u(noise):
        return idx.search_device(q + noise, K, p_tiles=p_tiles, tile_q=tile_q)

    qps_u = fenced_qps(run_u)
    print(f"unfiltered same-op-point qps={qps_u:,.0f}", flush=True)
    return harness.emit({"script": "bench_filtered", "card": card, "N": n, "nlist": NLIST,
                         "build_s": build_s, "rows": rows, "unfiltered_qps": qps_u,
                         "launches": harness.launches()})


if __name__ == "__main__":
    main()
