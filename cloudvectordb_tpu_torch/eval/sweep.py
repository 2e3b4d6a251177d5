"""nprobe sweep (counterpart of cloudvectordb_tpu/eval/sweep.py; BASELINE
config #2: the recall-against-QPS curve of an IVF index).

For an index and a query set: recall@k against the exact oracle and the
host-clock QPS of ``search`` at each nprobe, and the cheapest nprobe that
meets a recall floor. ``search`` returns numpy, so each timed call has
waited for the card; every timed iteration searches distinct inputs.
"""

from __future__ import annotations

import inspect
import time

import numpy as np

from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k


def nprobe_sweep(
    index,
    vectors: np.ndarray,
    queries: np.ndarray,
    k: int = 10,
    nprobes=(1, 2, 4, 8, 16, 32, 64),
    batch: int = 256,
    time_iters: int = 3,
    gt_ids: np.ndarray | None = None,
    **search_kw,
) -> list[dict]:
    """Returns [{nprobe, recall, qps, latency_ms}, ...], stopping after the
    first nprobe whose recall reaches 0.9999. ``search_kw`` goes to every
    ``search`` call (e.g. refine_factor)."""
    if gt_ids is None:
        _, gt_ids = brute_force_topk(vectors, queries, k, metric=index.metric)
    # the band indexes batch internally and take no batch=: pass it only to
    # the search() signatures that accept it (the probe-scan families)
    sig = inspect.signature(index.search)
    kw = dict(search_kw)
    if "batch" in sig.parameters or any(p.kind is inspect.Parameter.VAR_KEYWORD
                                        for p in sig.parameters.values()):
        kw["batch"] = batch
    out = []
    for nprobe in nprobes:
        nprobe = min(nprobe, getattr(index, "nlist", nprobe))
        _, found = index.search(queries, k, nprobe=nprobe, **kw)
        r = recall_at_k(found, gt_ids)
        index.search(queries[:batch], k, nprobe=nprobe, **kw)  # warm
        t0 = time.perf_counter()
        for it in range(time_iters):
            index.search(queries + np.float32(1e-4 * (it + 1)), k, nprobe=nprobe, **kw)
        dt = time.perf_counter() - t0
        out.append({
            "nprobe": int(nprobe),
            "recall": float(r),
            "qps": float(queries.shape[0] * time_iters / dt),
            "latency_ms": 1000.0 * dt / (time_iters * max(1, len(queries) // batch)),
        })
        if r >= 0.9999:
            break
    return out


def operating_point(sweep: list[dict], min_recall: float = 0.95) -> dict | None:
    """The cheapest nprobe meeting the recall floor (the serving config)."""
    for row in sweep:
        if row["recall"] >= min_recall:
            return row
    return None
