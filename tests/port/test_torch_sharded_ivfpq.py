"""parallel/dist_ivf.py::ShardedIVFPQIndex held to the JAX package's on its
eight simulated CPU devices, the same numpy inputs and the reference's
quantizers (``centroids=``, ``codebooks=``), the port's mesh eight shards
on the CPU: ids equal the reference's (ADC and int8 refine), the refine
store's scale and rows equal, add, remove, the 2-D replica mesh, range
search past one shard's rows, and the unfilled-slot fault of the
reference (arena row 0's id under -inf, where the port returns -1)."""

import numpy as np
import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.parallel.dist_ivf import ShardedIVFPQIndex as JaxShardedIVFPQIndex
from cloudvectordb_tpu.parallel.mesh import make_2d_mesh as jax_make_2d_mesh
from cloudvectordb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.parallel.dist_ivf import ShardedIVFPQIndex
from cloudvectordb_tpu_torch.parallel.mesh import make_2d_mesh, make_mesh

KW = dict(nlist=16, m=8, nbits=6, metric="ip", kmeans_iters=6, pq_train_iters=6, seed=3)
SCORE_TOL = 1e-5


def build_pair(db, jax_mesh=None, mesh=None, **kw):
    kw = {**KW, **kw}
    j = JaxShardedIVFPQIndex.build(db, mesh=jax_mesh or jax_make_mesh(axis_name="shard"), **kw)
    t = ShardedIVFPQIndex.build(db, mesh=mesh or make_mesh(8, devices=["cpu"]),
                                centroids=j._shards[0].centroids,
                                codebooks=j._shards[0].codebooks, **kw)
    return j, t


def assert_same_search(j, t, q, k=10, floor=0.99, **kw):
    vj, ij = j.search(q, k, **kw)
    vt, it = t.search(q, k, **kw)
    same = ij == it
    assert same.mean() >= floor, same.mean()
    np.testing.assert_allclose(vt[same], vj[same], rtol=0, atol=SCORE_TOL)
    return vt, it


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4096, 32, n_clusters=24, seed=64, normalize=True)
    q = queries_from(db, 32, seed=65, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    return db, q, gt


@pytest.fixture(scope="module")
def refined(data):
    return build_pair(data[0], refine="int8")


def test_parity_adc_and_refine(data, refined):
    db, q, gt = data
    j, t = refined
    assert t._refine_scale == pytest.approx(j._refine_scale, rel=1e-6)
    for si in range(8):
        np.testing.assert_array_equal(t._shards[si]._arena.ids, j._shards[si]._arena.ids)
        np.testing.assert_array_equal(t._shards[si]._arena.payload, j._shards[si]._arena.payload)
        d = np.abs(t._refine_arena_order(si).astype(np.int16)
                   - j._refine_arena_order(si).astype(np.int16))
        assert d.max() <= 1 and (d == 0).mean() >= 0.999
    for nprobe in (2, 16):
        _, it = assert_same_search(j, t, q, nprobe=nprobe)
    assert recall_at_k(it, gt) >= 0.85
    jp, tp = build_pair(db)  # ADC only
    _, ip = assert_same_search(jp, tp, q, nprobe=16)
    assert recall_at_k(it, gt) >= recall_at_k(ip, gt)


def test_add_and_remove(data, refined):
    db, q, _ = data
    j, t = build_pair(db[:2400], refine="int8")
    for s in range(2400, 3200, 200):
        np.testing.assert_array_equal(t.add(db[s:s + 200]), np.arange(s, s + 200))
        j.add(db[s:s + 200])
    assert t.ntotal == 3200
    assert_same_search(j, t, q, floor=0.98, nprobe=16)
    _, late = t.search(db[3000:3016], 1, nprobe=16)
    assert (late[:, 0] == np.arange(3000, 3016)).mean() >= 0.85
    removed = np.arange(0, 3200, 9)
    assert t.remove(removed) == removed.size == j.remove(removed)
    _, found = t.search(q, 10, nprobe=16, refine_factor=16)
    assert not np.isin(found, removed).any()
    t.add(db[3200:3296])
    assert t._next_id == 3296


def test_replica_mesh(data):
    db, q, _ = data
    j, t = build_pair(db, jax_mesh=jax_make_2d_mesh(2, 4),
                      mesh=make_2d_mesh(2, 4, devices=["cpu"]), refine="int8")
    one = ShardedIVFPQIndex.build(db, mesh=make_mesh(4, devices=["cpu"]),
                                  centroids=j._shards[0].centroids,
                                  codebooks=j._shards[0].codebooks, refine="int8", **KW)
    vt, it = assert_same_search(j, t, q[:30], nprobe=16)  # 30: the batch pads to 2 slices
    v1, i1 = one.search(q[:30], 10, nprobe=16)
    np.testing.assert_array_equal(it, i1)
    np.testing.assert_allclose(vt, v1, rtol=0, atol=SCORE_TOL)


def test_range_search_past_shard_capacity():
    db = clustered_vectors(2048, 32, n_clusters=16, seed=90, normalize=True)
    q = queries_from(db, 8, seed=91, normalize=True)
    _, t = build_pair(db, refine="int8")  # 8 shards of 256 rows
    lims, _, ids = t.range_search(q, -1.0, k_start=32, k_max=2048, nprobe=16)
    assert (np.diff(lims) > 256).all()  # wider than any one shard
    for i in range(q.shape[0]):
        row = ids[lims[i]:lims[i + 1]]
        assert len(set(row.tolist())) == len(row) and (row >= 0).all()


def test_unfilled_slots(data, refined):
    """A query whose probed lists hold fewer than k rows: the reference
    pads the refine with (-inf, 0) and maps row 0 through a shard's id
    table, so the unfilled slots carry a real id (queue 3's probe-scan
    fault, here across shards); the port returns (-inf, -1)."""
    _, q, _ = data
    j, t = refined
    vj, ij = j.search(q[:4], 300, nprobe=1, refine_factor=1)
    vt, it = t.search(q[:4], 300, nprobe=1, refine_factor=1)
    unfilled = np.isneginf(vt)
    assert unfilled.any()
    np.testing.assert_array_equal(np.isneginf(vj), unfilled)
    assert (it[unfilled] == -1).all()
    assert (ij[unfilled] >= 0).all()  # the reference's real ids in empty slots
    np.testing.assert_array_equal(it[~unfilled], ij[~unfilled])
