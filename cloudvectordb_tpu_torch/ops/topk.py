"""Tiled exact top-k over a vector matrix (counterpart of
cloudvectordb_tpu/ops/topk.py).

Streams the DB in tiles so the full (Q, N) score matrix is never
materialized; per tile the score block is one f32 matmul (TF32 off, see the
package docstring) and the merge is an exact top-k.

Scores are uniformly "larger is better": inner product for metric='ip',
-(||q-x||²) for metric='l2'. Ties go to the lower index, as ``lax.top_k``
does: ``torch.topk`` leaves tie order unspecified, so every top-k here is a
stable descending sort (``topk_stable``).
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def topk_stable(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ``lax.top_k``'s tie order: equal values
    keep their original order, so the lower position wins."""
    v, pos = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], pos[..., :k]


def _score_block(q: torch.Tensor, tile: torch.Tensor, metric: str,
                 tile_sqnorm: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, D) x (T, D) -> (Q, T) f32 scores, full-f32 matmul."""
    dots = q.float() @ tile.float().T
    if metric == "ip":
        return dots
    if metric == "l2":
        if tile_sqnorm is None:
            tf = tile.float()
            tile_sqnorm = (tf * tf).sum(dim=1)
        qf = q.float()
        q_sqnorm = (qf * qf).sum(dim=1)
        # -(||q||² - 2q·x + ||x||²): true negative squared distances
        return 2.0 * dots - tile_sqnorm[None, :] - q_sqnorm[:, None]
    raise ValueError(f"unknown metric {metric!r}")


def merge_topk(values_a, idx_a, values_b, idx_b, k: int):
    """Exact top-k of the union of two candidate sets (per row); on equal
    values the candidate from ``a`` wins."""
    vals = torch.cat([values_a, values_b], dim=1)
    idxs = torch.cat([idx_a, idx_b], dim=1)
    top_v, pos = topk_stable(vals, k)
    return top_v, torch.gather(idxs, 1, pos)


def tiled_topk(
    db: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    metric: str = "ip",
    tile: int = 8192,
    db_sqnorms: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``queries`` against ``db``.

    Returns (scores (Q, k) f32, indices (Q, k) int64) on the inputs' device.
    """
    n = db.shape[0]
    nq = queries.shape[0]
    k = min(k, n)
    best_v = torch.full((nq, k), NEG_INF, dtype=torch.float32, device=db.device)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=db.device)
    for start in range(0, n, tile):
        tile_x = db[start : start + tile]
        norms = None if db_sqnorms is None else db_sqnorms[start : start + tile].float()
        scores = _score_block(queries, tile_x, metric, norms)
        tv, tp = topk_stable(scores, min(k, tile_x.shape[0]))
        best_v, best_i = merge_topk(best_v, best_i, tv, tp + start, k)
    return best_v, best_i
