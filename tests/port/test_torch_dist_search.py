"""parallel/dist_search.py::DistributedFlatIndex held to the JAX package's
on its eight simulated CPU devices, the port's mesh eight shards on the
CPU (K2's plain version on each): ids equal the reference's and the exact
top-k (ip and l2), scores within 1e-5; incremental adds; pad rows never
returned; remove by original id (the reference's
tests/distributed/test_dist_search.py and
test_sharded_remove.py::test_distributed_flat_remove)."""

import numpy as np
import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.parallel.dist_search import (
    DistributedFlatIndex as JaxDistributedFlatIndex)
from cloudvectordb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.parallel.dist_search import DistributedFlatIndex
from cloudvectordb_tpu_torch.parallel.mesh import make_2d_mesh, make_mesh


def cpu_mesh(n: int = 8):
    return make_mesh(n, devices=["cpu"])


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_dist_flat_exact(metric):
    db = clustered_vectors(4000, 32, seed=40)  # not a multiple of 8: a short last shard
    q = queries_from(db, 16, seed=41)
    idx = DistributedFlatIndex.build(db, mesh=cpu_mesh(), metric=metric)
    v, i = idx.search(q, 10)
    gv, gt = brute_force_topk(db, q, 10, metric=metric)
    assert recall_at_k(i, gt) == 1.0
    jv, ji = JaxDistributedFlatIndex.build(db, mesh=jax_make_mesh(axis_name="shard"),
                                           metric=metric).search(q, 10)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-4)
    # a replica mesh serves slices of the batch with the same answer
    v3, i3 = DistributedFlatIndex.build(db, mesh=make_2d_mesh(2, 4, devices=["cpu"]),
                                        metric=metric).search(q, 10)
    np.testing.assert_array_equal(i3, i)


def test_dist_flat_incremental_add():
    db = clustered_vectors(3001, 16, seed=42)
    q = queries_from(db, 8, seed=43)
    idx = DistributedFlatIndex(mesh=cpu_mesh(), metric="ip")
    idx.add(db[:1000])
    idx.add(db[1000:])
    assert idx.ntotal == 3001
    _, i = idx.search(q, 5)
    _, gt = brute_force_topk(db, q, 5, metric="ip")
    assert recall_at_k(i, gt) == 1.0


def test_padding_rows_never_returned():
    db = clustered_vectors(17, 16, seed=44)  # 3 rows a shard: the last two shards empty
    q = queries_from(db, 4, seed=45)
    idx = DistributedFlatIndex.build(db, mesh=cpu_mesh(), metric="ip")
    v, i = idx.search(q, 10)
    assert i.shape == (4, 10) and i.max() < 17 and i.min() >= 0
    _, ji = JaxDistributedFlatIndex.build(db, mesh=jax_make_mesh(axis_name="shard")).search(q, 10)
    np.testing.assert_array_equal(i, ji)


def test_distributed_flat_remove():
    db = clustered_vectors(1024, 32, n_clusters=16, seed=194, normalize=True)
    q = queries_from(db, 16, seed=195, normalize=True)
    idx = DistributedFlatIndex.build(db, mesh=cpu_mesh())
    jidx = JaxDistributedFlatIndex.build(db, mesh=jax_make_mesh(axis_name="shard"))
    removed = np.arange(0, 1024, 3)
    assert idx.remove(removed) == removed.size == jidx.remove(removed)
    assert idx.ntotal == 1024 - removed.size
    keep = np.setdiff1d(np.arange(1024), removed)
    _, gt_pos = brute_force_topk(db[keep], q, 10, metric="ip")
    _, found = idx.search(q, 10)
    assert not np.isin(found, removed).any()
    assert recall_at_k(found, keep[gt_pos]) == 1.0
    np.testing.assert_array_equal(found, jidx.search(q, 10)[1])
    assert idx.remove(removed[:7]) == 0  # unknown or repeated ids are ignored
    idx.add(db[:8])  # re-added rows take new ids: freed ids are never reused
    _, f2 = idx.search(db[3:4], 1)
    assert f2[0, 0] >= 1024
