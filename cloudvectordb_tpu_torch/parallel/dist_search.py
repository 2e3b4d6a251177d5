"""Row-sharded exact index over a mesh (counterpart of
cloudvectordb_tpu/parallel/dist_search.py: ``DistributedFlatIndex``).

The compact (N, D) f32 rows are kept on the host and split into contiguous
blocks of ceil(N / S) rows, the reference's partition; each block lives on
its shard slot's device. A search scans every held block with the fused
flat top-k (K2, ops/flat_topk.py: the hand-written kernel on CUDA tensors,
its plain version on CPU ones), offsets the block rows to global positions
and merges the partials in shard order (parallel/mesh.py). K2 keeps one
slot per bucket of rows (``tile_n`` 2048): below that many rows a block's
top-k is exact, above it two of a query's top-k that share a bucket keep
only the better, as the reference's ``flat_topk_pallas`` does on a TPU.
Rows past a shard's count never surface: a block holds only real rows.
"""

from __future__ import annotations

import numpy as np
import torch

from cloudvectordb_tpu_torch.index.arena import normalize_remove_ids
from cloudvectordb_tpu_torch.ops.flat_topk import flat_topk
from cloudvectordb_tpu_torch.ops.topk import NEG_INF
from cloudvectordb_tpu_torch.parallel.mesh import (
    Mesh, fetch_local, make_mesh, merge_partials, replica_slices, stage_queries,
    stage_replicated, stage_row_sharded)


class DistributedFlatIndex:
    """Row-sharded exact index. With several processes every process calls
    ``add`` and ``remove`` with the same arguments (each keeps the host
    rows and stages only the blocks its slots hold)."""

    def __init__(self, mesh: Mesh | None = None, metric: str = "ip"):
        if metric not in ("ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        self.mesh = mesh or make_mesh()
        self.metric = metric
        self._rows = np.zeros((0, 0), np.float32)  # compact host rows
        # original-id map, materialized by the first remove() (until then
        # row position == id); new ids keep allocating past _next_id
        self._ids: np.ndarray | None = None
        self._next_id = 0
        self._dev: dict | None = None  # (replica, shard) -> (rows, sqnorms, base)

    @property
    def ntotal(self) -> int:
        return int(self._rows.shape[0])

    @classmethod
    def build(cls, vectors, mesh: Mesh | None = None, metric: str = "ip"):
        idx = cls(mesh, metric)
        idx.add(vectors)
        return idx

    def _place(self, rows: np.ndarray) -> None:
        self._rows = np.ascontiguousarray(rows, np.float32)
        self._dev = None

    def _staged(self) -> dict:
        """Each held block on its slot's device, with its l2 norms and the
        global position of its first row."""
        if self._dev is None:
            s = self.mesh.n_shard
            rps = -(-self.ntotal // s)
            blocks = stage_row_sharded(lambda si: self._rows[si * rps:(si + 1) * rps], s,
                                       self.mesh)
            self._dev = {}
            for (r, si), t in blocks.items():
                sq = (t * t).sum(dim=1) if self.metric == "l2" else None
                self._dev[(r, si)] = (t, sq, si * rps)
        return self._dev

    def add(self, vectors) -> None:
        vectors = np.asarray(vectors, np.float32)
        if self._ids is not None:  # id map live after a remove()
            b = vectors.shape[0]
            self._ids = np.concatenate(
                [self._ids, np.arange(self._next_id, self._next_id + b, dtype=np.int64)])
            self._next_id += b
        self._place(vectors if not self.ntotal else np.concatenate([self._rows, vectors]))

    def remove(self, ids) -> int:
        """Delete by original id: the survivors compact and re-shard; the id
        map materializes on the first remove so search keeps returning
        original ids. Freed ids are never reused."""
        req = normalize_remove_ids(ids)
        n = self.ntotal
        if req.size == 0 or n == 0:
            return 0
        cur = self._ids if self._ids is not None else np.arange(n, dtype=np.int64)
        self._next_id = max(self._next_id, n)
        keep = ~np.isin(cur, req)
        n_rem = int((~keep).sum())
        if n_rem == 0:
            return 0
        self._ids = cur[keep]
        self._place(self._rows[keep])
        return n_rem

    def search(self, queries, k: int):
        """(scores (Q, k') f32, ids (Q, k') int64), k' = min(k, the merged
        pool): K2 on every held block, merged in shard order."""
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        n_rep = self.mesh.n_replica if self.mesh.nproc == 1 else 1
        q_pad = -(-nq // n_rep) * n_rep
        qp = queries if q_pad == nq else np.concatenate(
            [queries, np.repeat(queries[-1:], q_pad - nq, axis=0)])
        qp = stage_queries(qp, self.mesh, statics=(k,))
        staged = self._staged()
        outs_v, outs_i = [], []
        for r, sl in replica_slices(self.mesh, q_pad):
            parts, q_on = [], stage_replicated(qp[sl], self.mesh)
            for si in range(self.mesh.n_shard):
                if (r, si) not in staged:
                    continue
                rows, sq, base = staged[(r, si)]
                q = q_on[rows.device]
                if rows.shape[0] == 0:  # a block past the last row
                    parts.append((torch.full((q.shape[0], 1), NEG_INF, device=q.device),
                                  torch.full((q.shape[0], 1), -1, device=q.device)))
                    continue
                v, i = flat_topk(rows, q, min(k, rows.shape[0]), metric=self.metric,
                                 db_sqnorms=sq)
                parts.append((v, torch.where(v > NEG_INF, i.long() + base, -1)))
            v, i = merge_partials(parts, k, self.mesh)
            outs_v.append(fetch_local(v))
            outs_i.append(fetch_local(i))
        v, i = np.concatenate(outs_v)[:nq], np.concatenate(outs_i)[:nq]
        if self._ids is not None:  # positions -> original ids
            i = np.where(i >= 0, self._ids[np.clip(i, 0, max(self.ntotal - 1, 0))], -1)
        return v, i
