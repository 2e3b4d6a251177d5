"""Range search: every stored vector within a score or distance threshold
(counterpart of cloudvectordb_tpu/index/range.py).

Range semantics come from the family's top-k search by k-escalation:
search at k, find the queries whose k-th score still clears the threshold
(saturated: the ball may extend past k), search the whole batch again at
2k, and repeat. Results come back CSR-style, as FAISS ``range_search``
gives them: (lims, scores, ids).
"""

from __future__ import annotations

import warnings

import numpy as np


class RangeSearchMixin:
    """``range_search()`` for every family (index/base.py's ``Index``), in
    one place. Requires ``self.search(queries, k, **kw) -> (scores, ids)``
    with the (-inf, -1) convention for unfilled slots, plus ``metric`` and
    ``ntotal``."""

    def range_search(
        self,
        queries,
        radius: float,
        *,
        k_start: int = 64,
        k_max: int = 2048,
        **kw,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All stored vectors within ``radius`` of each query.

        Threshold semantics follow the metric:
          - ``ip`` (and normalized-cosine setups): hit iff score >= radius.
          - ``l2``: ``radius`` is SQUARED L2 distance (FAISS convention);
            hit iff ||q - x||^2 <= radius. Returned scores stay in this
            index's own convention (-||q - x||^2, larger is better).

        Returns ``(lims, scores, ids)`` CSR-style: query ``i``'s hits are
        ``ids[lims[i]:lims[i+1]]``, sorted by descending score. Exact on
        exact families; on ANN families the candidate set is whatever the
        family's search surfaces at the final k (same approximation
        contract as top-k search; pass nprobe/p_tiles/... through ``kw``).
        Per-query results are capped at ``k_max`` (a warning names the
        truncated count) — raise ``k_max`` for denser radii.
        """
        q = np.asarray(queries)
        nq = int(q.shape[0])
        metric = getattr(self, "metric", "ip")
        thresh = -float(radius) if metric == "l2" else float(radius)
        n = int(getattr(self, "ntotal", 0))
        if nq == 0 or n == 0:
            return (
                np.zeros(nq + 1, np.int64),
                np.zeros((0,), np.float32),
                np.zeros((0,), np.int64),
            )
        cap = max(1, min(int(k_max), n))
        k = max(1, min(int(k_start), cap))
        while True:
            s, i = self.search(q, k, **kw)
            s, i = np.asarray(s), np.asarray(i)
            valid = i >= 0
            # saturated: every slot filled AND the worst retained score still
            # clears the threshold — the radius ball may extend past this k
            worst = np.where(valid, s, np.inf).min(axis=1)
            saturated = valid.all(axis=1) & (worst >= thresh)
            if s.shape[1] < k:
                # the family surfaced fewer candidates than requested (e.g.
                # the band kernel's per-query pool is l_buckets wide;
                # sharded merges pool shards × that): escalating k further
                # cannot widen the result — stop, and say so if any ball
                # may extend past the pool
                if saturated.any():
                    warnings.warn(
                        f"range_search: {int(saturated.sum())}/{nq} queries "
                        f"still saturated at this index's candidate-pool "
                        f"ceiling ({s.shape[1]}); results may be incomplete "
                        "— use a flat/IVF family (or more shards) for radii "
                        "this dense",
                        stacklevel=2,
                    )
                break
            if not saturated.any() or k >= cap:
                if saturated.any() and k < n:  # k == ntotal: nothing cut off
                    warnings.warn(
                        f"range_search truncated {int(saturated.sum())}/{nq} "
                        f"queries at k_max={cap}; raise k_max for full "
                        "results",
                        stacklevel=2,
                    )
                break
            k = min(cap, 2 * k)
        hit = valid & (s >= thresh)
        counts = hit.sum(axis=1)
        lims = np.zeros(nq + 1, np.int64)
        np.cumsum(counts, out=lims[1:])
        # stable per-row descending-score order, hits packed to the front
        order = np.argsort(np.where(hit, -s.astype(np.float64), np.inf),
                           axis=1, kind="stable")
        s_sorted = np.take_along_axis(s, order, axis=1)
        i_sorted = np.take_along_axis(i, order, axis=1)
        hit_sorted = np.take_along_axis(hit, order, axis=1)
        return lims, s_sorted[hit_sorted], i_sorted[hit_sorted].astype(np.int64)
