"""Shared helpers of the index families (counterpart of
cloudvectordb_tpu/index/arena.py): the remove() request contract
(``normalize_remove_ids``), the gid-keyed table growth of ``merge_from``
(``grow_scatter_gid``), the host list arena of the probe-scan families
(``ListArena``: rows sorted by list, (nlist + 1,) offsets) and the LSM
pending buffer (``PendingBuffer``) that ``add`` appends to. Rows in the
buffer are scanned exactly at query time; the index folds them into its
device annex or merges them into the arena once the buffer outgrows a
fraction of the arena, so ``add`` stays O(batch) amortized. All of it is
host numpy, as in the reference.
"""

from __future__ import annotations

import numpy as np

from cloudvectordb_tpu_torch.utils.native import arena_sort, gather_rows


def normalize_remove_ids(ids) -> np.ndarray:
    """The remove() request contract, shared by every index family: any int
    array-like -> sorted unique non-negative int64 ids (negative entries,
    the hole marker value, are dropped)."""
    req = np.unique(np.asarray(ids, np.int64).ravel())
    return req[req >= 0]


def grow_scatter_gid(base: np.ndarray, rows: np.ndarray, gids: np.ndarray) -> np.ndarray:
    """A copy of the gid-keyed table ``base`` grown to cover ``gids``
    (zero-filling any id-space gaps), with ``rows`` scattered at those
    keys: how ``merge_from`` consolidates a gid-keyed side store (the int8
    refine rows)."""
    base = np.asarray(base)
    hi = max(int(gids.max(initial=-1)) + 1, base.shape[0])
    out = np.zeros((hi, *base.shape[1:]), base.dtype)
    out[: base.shape[0]] = base
    out[gids] = rows
    return out


class ListArena:
    """Host container of list-sorted payload rows and their global ids:
    list l's rows are ``payload[offsets[l]:offsets[l + 1]]``."""

    def __init__(self, nlist: int, payload_width: int, payload_dtype):
        self.nlist = nlist
        self.payload = np.zeros((0, payload_width), payload_dtype)
        self.ids = np.zeros((0,), np.int64)
        self.offsets = np.zeros((nlist + 1,), np.int64)

    @property
    def size(self) -> int:
        return self.payload.shape[0]

    @property
    def list_lens(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def max_list_len(self) -> int:
        return int(self.list_lens.max()) if self.size else 0

    def rebuild(self, payload: np.ndarray, ids: np.ndarray, assignments: np.ndarray) -> None:
        """Replace the contents with the rows sorted by list assignment
        (stable), through the native counting sort (utils/native.py)."""
        order, offsets = arena_sort(np.asarray(assignments), self.nlist)
        self.payload = gather_rows(np.asarray(payload), order)
        self.ids = np.asarray(ids)[order]
        self.offsets = offsets

    def merge(self, payload: np.ndarray, ids: np.ndarray, assignments: np.ndarray) -> None:
        """Merge new rows in: one re-sort of the union."""
        if self.size == 0:
            self.rebuild(payload, ids, assignments)
            return
        old_assign = np.repeat(np.arange(self.nlist), self.list_lens)
        self.rebuild(
            np.concatenate([self.payload, payload.astype(self.payload.dtype)]),
            np.concatenate([self.ids, ids]),
            np.concatenate([old_assign, assignments]))

    def remove_ids(self, req: np.ndarray) -> int:
        """Drop the rows whose id is in ``req`` (sorted unique int64) by one
        boolean-mask compaction; rows stay list-sorted, so only the offsets
        are recomputed. Returns the number removed; unknown ids are
        ignored."""
        if self.size == 0:
            return 0
        keep = ~np.isin(self.ids, req)
        n_rem = int(self.size - keep.sum())
        if n_rem == 0:
            return 0
        assign = np.repeat(np.arange(self.nlist), self.list_lens)[keep]
        # fancy indexing copies: safe on read-only memory-mapped arrays too
        self.payload = np.asarray(self.payload)[keep]
        self.ids = np.asarray(self.ids)[keep]
        counts = np.bincount(assign, minlength=self.nlist)
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return n_rem


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
