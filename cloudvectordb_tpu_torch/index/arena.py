"""Shared helpers of the index families (counterpart of
cloudvectordb_tpu/index/arena.py): the remove() request contract
(``normalize_remove_ids``) and the LSM pending buffer (``PendingBuffer``)
that ``BandIVFIndex.add`` appends to. Rows in the buffer are scanned
exactly at query time; the index folds them into its device annex or
merges them into the arena once the buffer outgrows a fraction of the
arena, so ``add`` stays O(batch) amortized. (The reference's host
``ListArena`` and ``grow_scatter_gid`` come with the probe-scan and
PQ-tiles families.)
"""

from __future__ import annotations

import numpy as np


def normalize_remove_ids(ids) -> np.ndarray:
    """The remove() request contract, shared by every index family: any int
    array-like -> sorted unique non-negative int64 ids (negative entries,
    the hole marker value, are dropped)."""
    req = np.unique(np.asarray(ids, np.int64).ravel())
    return req[req >= 0]


class PendingBuffer:
    """Flat append-only host buffer of not-yet-merged inserts: chunks of
    (payload rows, global ids, list assignments)."""

    def __init__(self, payload_width: int, payload_dtype):
        self._chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self.width = payload_width
        self.dtype = payload_dtype

    @property
    def size(self) -> int:
        return sum(c[0].shape[0] for c in self._chunks)

    def append(self, payload, ids, assignments) -> None:
        self._chunks.append(
            (np.asarray(payload, self.dtype), np.asarray(ids), np.asarray(assignments)))

    def drain(self):
        """(payload, ids, assignments) of every pending row, and clear."""
        snap = self.snapshot_full()
        if snap is None:
            e = np.zeros((0, self.width), self.dtype)
            return e, np.zeros((0,), np.int64), np.zeros((0,), np.int64)
        self._chunks.clear()
        return snap

    def snapshot(self):
        """(payload, ids) without clearing, or None when empty."""
        snap = self.snapshot_full()
        return None if snap is None else snap[:2]

    def snapshot_full(self):
        """(payload, ids, assignments) without clearing, or None when empty;
        the assignments let residual-encoded rows rebuild their centroid
        term."""
        if not self._chunks:
            return None
        p = np.concatenate([c[0] for c in self._chunks])
        i = np.concatenate([c[1] for c in self._chunks])
        a = np.concatenate([c[2] for c in self._chunks])
        return p, i, a

    def remove_ids(self, req: np.ndarray) -> tuple[int, list[np.ndarray]]:
        """Drop pending rows whose id is in ``req``. Returns (n_removed,
        keep_masks): one bool mask per chunk as it was before the call, in
        order, so a caller with chunk-parallel side lists can filter them
        alike. Chunks left empty are dropped."""
        masks: list[np.ndarray] = []
        n_rem = 0
        kept: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for p, i, a in self._chunks:
            keep = ~np.isin(i, req)
            masks.append(keep)
            n_rem += int(i.shape[0] - keep.sum())
            if keep.all():
                kept.append((p, i, a))
            elif keep.any():
                kept.append((p[keep], i[keep], a[keep]))
        self._chunks = kept
        return n_rem, masks
