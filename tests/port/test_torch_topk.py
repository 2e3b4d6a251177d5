"""Exact top-k (ops/topk.py) and the numpy recall harness: the port against
the reference on the same numpy inputs.

Tolerances: scores within 1e-5 absolute (f32 matmuls summed in another
order); ids equal except where the two scores at that rank are a near-tie
(within 1e-5)."""

import numpy as np
import pytest
import torch

from cloudvectordb_tpu.eval.recall import brute_force_topk as jax_brute_force_topk
from cloudvectordb_tpu.ops.topk import tiled_topk as jax_tiled_topk
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.ops.topk import merge_topk, tiled_topk, topk_stable

TOL = 1e-5


def _assert_agree(v_ref, i_ref, v, i):
    np.testing.assert_allclose(v, v_ref, atol=TOL, rtol=0)
    same = i == np.asarray(i_ref)
    assert np.all(np.abs(v - v_ref)[~same] <= TOL)
    assert same.mean() >= 0.99


def _data(seed, n=3000, d=48, nq=40):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, d)).astype(np.float32) / np.sqrt(d)
    q = rng.normal(size=(nq, d)).astype(np.float32) / np.sqrt(d)
    return db, q


@pytest.mark.parametrize("tile", [1024, 8192], ids=["ragged_tiles", "one_tile"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_tiled_topk_matches_reference(metric, tile):
    db, q = _data(0)
    v_j, i_j = (np.asarray(a) for a in jax_tiled_topk(db, q, 10, metric=metric, tile=tile))
    v, i = tiled_topk(torch.from_numpy(db), torch.from_numpy(q), 10, metric=metric,
                      tile=tile)
    _assert_agree(v_j, i_j, v.numpy(), i.numpy())


def test_tiled_topk_l2_with_given_norms():
    db, q = _data(1)
    norms = (db * db).sum(1)
    v_j, i_j = jax_tiled_topk(db, q, 7, metric="l2", tile=1024, db_sqnorms=norms)
    v, i = tiled_topk(torch.from_numpy(db), torch.from_numpy(q), 7, metric="l2",
                      tile=1024, db_sqnorms=torch.from_numpy(norms))
    _assert_agree(np.asarray(v_j), i_j, v.numpy(), i.numpy())


def test_exact_ties_go_to_the_lower_index():
    """Duplicate rows tie exactly; the reference's lax.top_k puts the lower
    index first, across tiles too."""
    db, q = _data(2, n=600)
    db[300:600] = db[0:300]  # every row has a twin 300 rows later
    v_j, i_j = jax_tiled_topk(db, q, 10, tile=256)
    v, i = tiled_topk(torch.from_numpy(db), torch.from_numpy(q), 10, tile=256)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    assert (i.numpy()[:, 0] < 300).all()


def test_merge_topk_prefers_first_set_on_ties():
    va = torch.tensor([[3.0, 1.0]])
    vb = torch.tensor([[3.0, 2.0]])
    v, i = merge_topk(va, torch.tensor([[10, 11]]), vb, torch.tensor([[20, 21]]), 3)
    assert v.tolist() == [[3.0, 3.0, 2.0]] and i.tolist() == [[10, 20, 21]]
    _, pos = topk_stable(torch.tensor([[1.0, 5.0, 5.0, 0.0]]), 2)
    assert pos.tolist() == [[1, 2]]


def test_tiled_topk_k_larger_than_db():
    db, q = _data(3, n=5)
    v, i = tiled_topk(torch.from_numpy(db), torch.from_numpy(q), 10)
    assert v.shape == (q.shape[0], 5)
    _, i_np = brute_force_topk(db, q, 10)
    np.testing.assert_array_equal(i.numpy(), i_np)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_recall_harness_is_the_reference(metric):
    db, q = _data(4, n=2000)
    s_j, i_j = jax_brute_force_topk(db, q, 10, metric=metric, block=512)
    s, i = brute_force_topk(db, q, 10, metric=metric, block=512)
    np.testing.assert_array_equal(i, i_j)
    np.testing.assert_array_equal(s, s_j)
    assert recall_at_k(i, i_j) == 1.0
    assert recall_at_k(i[:, ::-1], i_j, k=5) < 1.0
