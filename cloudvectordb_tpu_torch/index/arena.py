"""Shared helpers of the index families (counterpart of
cloudvectordb_tpu/index/arena.py; this slice ports ``normalize_remove_ids``,
which ``FlatIndex.remove`` needs. The pending buffer and the other arena
helpers come with the mutation slice)."""

from __future__ import annotations

import numpy as np


def normalize_remove_ids(ids) -> np.ndarray:
    """The remove() request contract, shared by every index family: any int
    array-like -> sorted unique non-negative int64 ids (negative entries,
    the hole marker value, are dropped)."""
    req = np.unique(np.asarray(ids, np.int64).ravel())
    return req[req >= 0]
