"""The tuner's reference search (eval/tune.py): with no ground truth given,
the index's max-effort config is the reference, and where it runs out of
device memory the walk goes down the ladder, most expensive first, as the
reference's (cloudvectordb_tpu/eval/tune.py:128-146) does. Only an
out-of-memory error moves it down; anything else raises."""

import numpy as np
import pytest
import torch

from cloudvectordb_tpu_torch.eval.tune import tune_index


class StubIndex:
    """An index whose search answers ids that name the config's depth
    (p_tiles) and raises ``fail[p]`` for the depths listed there."""

    device = "cpu"

    def __init__(self, fail: dict):
        self.fail = fail
        self.calls = []

    def _tune_candidates(self, nq):
        return [{"p_tiles": p, "tile_q": 32} for p in (4, 8, 16)]

    def _tune_reference_kw(self, nq):
        return {"p_tiles": 64, "tile_q": 32}

    def search(self, queries, k, p_tiles, tile_q):
        self.calls.append(p_tiles)
        if p_tiles in self.fail:
            raise self.fail[p_tiles]
        # recall against depth 16's ids is 1 for depth 16 and above, else 0
        ids = np.full((queries.shape[0], k), min(p_tiles, 16), np.int64)
        ids += np.arange(k)[None, :] * 100
        return np.zeros(ids.shape, np.float32), ids


def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory (stub)")


def test_reference_search_walks_down_the_ladder_on_out_of_memory():
    idx = StubIndex({64: _oom()})
    q = np.zeros((8, 4), np.float32)
    report = tune_index(idx, q, k=5, target_recall=0.9)
    # the reference fell to the deepest candidate (16), so only depth 16
    # reaches recall 1: its ids became the ground truth
    assert idx.calls[:2] == [64, 16]
    assert report["met"] and report["op"]["p_tiles"] == 16
    assert [t["recall"] for t in report["tried"]] == [0.0, 0.0, 1.0]


def test_reference_search_raises_when_every_config_runs_out_of_memory():
    idx = StubIndex({p: _oom() for p in (4, 8, 16, 64)})
    with pytest.raises(RuntimeError, match="out of device memory"):
        tune_index(idx, np.zeros((8, 4), np.float32), k=5)
    assert idx.calls == [64, 16, 8, 4]


def test_reference_search_propagates_other_errors():
    idx = StubIndex({64: ValueError("kernel launch failed (stub)")})
    with pytest.raises(ValueError, match="stub"):
        tune_index(idx, np.zeros((8, 4), np.float32), k=5)
    assert idx.calls == [64]
