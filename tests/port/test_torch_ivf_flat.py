"""IVF-Flat: the port held to the reference on the same data and the same
coarse quantizer (the reference's centroids given to the port's build).

Tolerances: scores within 1e-5 (the f32 probe scan, TF32 off, against the
reference's f32 einsum); ids equal on >= 99% of slots, each differing slot a
near-tie (its two scores within 1e-5).

1. The probe scan at nprobe 1, 4 and 16 for ip and l2; at nprobe = nlist it
   is the exact flat scan (recall 1.0, as tests/unit/test_indexes.py:51
   requires of the reference).
2. Pending rows (uneven adds, some left pending) scanned flat and merged.
3. ``remove``: the same ids from both; no removed id comes back.
4. Persistence both ways: an artifact of either package loads in the other.
5. Unfilled slots: the port returns (-inf, -1); the reference returns id 0
   there (a real id), recorded beside it.
"""

import numpy as np
import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.index import load_index as jax_load_index
from cloudvectordb_tpu.index.ivf_flat import IVFFlatIndex as JaxIVFFlatIndex
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.index.ivf_flat import IVFFlatIndex
from cloudvectordb_tpu_torch.index.registry import load_index

D, NLIST, K = 32, 16, 10
TOL = 1e-5


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(3000, D, n_clusters=24, seed=120, normalize=True)
    q = queries_from(db, 40, seed=121, normalize=True)
    return db, q


@pytest.fixture(scope="module", params=["ip", "l2"])
def pair(request, data):
    """(reference index, port index) over the same rows and centroids."""
    j = JaxIVFFlatIndex.build(data[0], nlist=NLIST, metric=request.param, kmeans_iters=5)
    t = IVFFlatIndex.build(data[0], NLIST, metric=request.param, centroids=j.centroids,
                           device="cpu")
    return j, t


def assert_same(vt, it, vj, ij, tol=TOL):
    """Scores within tol; ids equal on >= 99% of slots, each differing slot
    a near-tie."""
    vj, ij = np.asarray(vj), np.asarray(ij)
    np.testing.assert_allclose(vt, vj, atol=tol, rtol=0)
    same = it == ij
    assert same.mean() >= 0.99 and np.all(np.abs(vt - vj)[~same] <= tol)


def test_layout_is_the_reference(pair):
    j, t = pair
    np.testing.assert_array_equal(t._arena.offsets, j._arena.offsets)
    np.testing.assert_array_equal(t._arena.ids, j._arena.ids)
    np.testing.assert_array_equal(t._arena.payload, j._arena.payload)


@pytest.mark.parametrize("nprobe", [1, 4, NLIST])
def test_probe_scan(pair, data, nprobe):
    j, t = pair
    db, q = data
    vt, it = t.search(q, K, nprobe=nprobe)
    assert vt.dtype == np.float32 and it.dtype == np.int64
    assert_same(vt, it, *j.search(q, K, nprobe=nprobe))
    if nprobe == NLIST:  # every list probed: the exact flat scan
        _, gt = brute_force_topk(db, q, K, metric=t.metric)
        assert recall_at_k(it, gt) == 1.0


def test_probe_steps_do_not_change_the_result(pair, data, monkeypatch):
    """A step of one probe rank and steps of many give the same slots."""
    from cloudvectordb_tpu_torch.index import ivf_flat

    _, t = pair
    v1, i1 = t.search(data[1], K, nprobe=8)
    monkeypatch.setattr(ivf_flat, "PROBE_STEP_ELEMS", 1)
    v2, i2 = t.search(data[1], K, nprobe=8)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(v1, v2)


def test_pending_rows_and_remove(data):
    db, q = data
    j = JaxIVFFlatIndex(D, NLIST, metric="ip", kmeans_iters=5)
    j.train(db[:1000])
    t = IVFFlatIndex(D, NLIST, metric="ip", device="cpu")
    t.train(None, centroids=j.centroids)
    for s in range(0, db.shape[0], 700):  # uneven batches; the last stays pending
        j.add(db[s:s + 700])
        t.add(db[s:s + 700])
    assert t._pending.size == j._pending.size > 0 and t.ntotal == j.ntotal
    for nprobe in (2, NLIST):
        vt, it = t.search(q, K, nprobe=nprobe)
        assert_same(vt, it, *j.search(q, K, nprobe=nprobe))
    _, gt = brute_force_topk(db, q, K)
    assert recall_at_k(t.search(q, K, nprobe=NLIST)[1], gt) == 1.0  # full probe + pending
    victims = np.concatenate([np.arange(0, 3000, 7), np.arange(2800, 2900)])
    assert t.remove(victims) == j.remove(victims) > 0
    vt, it = t.search(q, K, nprobe=4)
    assert_same(vt, it, *j.search(q, K, nprobe=4))
    assert not np.isin(it, victims).any()
    assert t.remove(victims) == 0


def test_persistence_both_ways(pair, data, tmp_path):
    j, t = pair
    q = data[1]
    t.save(tmp_path / "port")
    jl = jax_load_index(tmp_path / "port")
    assert jl.kind == "ivf_flat" and jl.ntotal == t.ntotal
    j.save(tmp_path / "ref")
    tl = load_index(tmp_path / "ref", device="cpu")
    assert isinstance(tl, IVFFlatIndex) and tl.metric == t.metric
    vt, it = tl.search(q, K, nprobe=4)
    np.testing.assert_array_equal(it, t.search(q, K, nprobe=4)[1])
    assert_same(vt, it, *jl.search(q, K, nprobe=4))


def test_unfilled_slots(data):
    """k beyond the probed rows: the port's tail is (-inf, -1); the
    reference's is (-inf, 0), a real id (ROADMAP queue 3)."""
    db, q = data
    small = db[:60]
    j = JaxIVFFlatIndex.build(small, nlist=8, metric="ip", kmeans_iters=3)
    t = IVFFlatIndex.build(small, 8, metric="ip", centroids=j.centroids, device="cpu")
    vj, ij = (np.asarray(a) for a in j.search(q[:4], 40, nprobe=1))
    vt, it = t.search(q[:4], 40, nprobe=1)
    filled = np.isfinite(vt)
    assert (~filled).any() and np.array_equal(filled, np.isfinite(vj))
    assert np.all(it[~filled] == -1) and np.all(ij[~filled] == 0)
    np.testing.assert_allclose(vt[filled], vj[filled], atol=TOL, rtol=0)
    assert (it[filled] == ij[filled]).mean() >= 0.99


def test_tune_picks_a_passing_nprobe(pair, data):
    _, t = pair
    db, q = data
    _, gt = brute_force_topk(db, q, K, metric=t.metric)
    report = t.tune(q, K, target_recall=0.9, gt=gt)
    assert report["met"] and report["recall"] >= 0.9
    assert recall_at_k(t.search(q, K)[1], gt) == report["recall"]
