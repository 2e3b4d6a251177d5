"""Ground-truth + recall harness (copy of cloudvectordb_tpu/eval/recall.py).

Plain numpy: exact brute-force top-k computed in float64 blocks, independent
of both frameworks.
"""

from __future__ import annotations

import numpy as np


def brute_force_topk(
    db: np.ndarray,
    queries: np.ndarray,
    k: int,
    metric: str = "ip",
    block: int = 4096,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k (scores, indices) by blocked scan; float64 accumulation.

    metric='ip'  → larger is better (inner product / cosine on unit vectors)
    metric='l2'  → smaller squared-L2 is better; returned scores are -||q-x||²
                   so that, uniformly, larger score == better for both metrics.
    """
    nq = queries.shape[0]
    n = db.shape[0]
    k = min(k, n)
    qf = queries.astype(np.float64)
    best_s = np.full((nq, k), -np.inf)
    best_i = np.zeros((nq, k), dtype=np.int64)
    if metric == "l2":
        q_norm = (qf * qf).sum(axis=1, keepdims=True)
    for start in range(0, n, block):
        xb = db[start : start + block].astype(np.float64)
        dots = qf @ xb.T
        if metric == "ip":
            s = dots
        elif metric == "l2":
            x_norm = (xb * xb).sum(axis=1)[None, :]
            s = -(q_norm - 2.0 * dots + x_norm)
        else:
            raise ValueError(f"unknown metric {metric!r}")
        cand_s = np.concatenate([best_s, s], axis=1)
        cand_i = np.concatenate(
            [best_i, np.broadcast_to(np.arange(start, start + xb.shape[0]), s.shape)],
            axis=1,
        )
        part = np.argpartition(-cand_s, k - 1, axis=1)[:, :k]
        rows = np.arange(nq)[:, None]
        best_s = cand_s[rows, part]
        best_i = cand_i[rows, part]
        order = np.argsort(-best_s, axis=1, kind="stable")
        best_s = best_s[rows, order]
        best_i = best_i[rows, order]
    return best_s, best_i


def recall_at_k(found_ids: np.ndarray, true_ids: np.ndarray, k: int | None = None) -> float:
    """Fraction of true top-k ids recovered, averaged over queries."""
    found_ids = np.asarray(found_ids)
    true_ids = np.asarray(true_ids)
    if k is None:
        k = true_ids.shape[1]
    found = found_ids[:, :k]
    true = true_ids[:, :k]
    hits = 0
    for f, t in zip(found, true):
        hits += len(set(f.tolist()) & set(t.tolist()))
    return hits / (true.shape[0] * k)
