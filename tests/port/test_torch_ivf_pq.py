"""IVF-PQ and the ADC scan: the port held to the reference on the same data
and the same quantizers (the reference's centroids, codebooks and OPQ
matrix given to the port; on the reference's side the attributes are set
before ``add``).

Tolerances: ADC sums within 1e-4 (m f32 table entries summed in another
order); the lookup tables, the coarse terms and the f32 refine rescore
(TF32 off) within 1e-5; ids equal on >= 99% of slots, each differing slot
a near-tie (its two scores within the tolerance); codes equal byte for
byte; int8 refine rows equal on >= 99.99% of bytes with |diff| <= 1 (the
refine scale is an f64 mean whose summation order differs between the
frameworks, so a row can move by one step at a rounding edge).

1. ``_build_luts`` (ip, l2) and ``adc_scan`` against
   cloudvectordb_tpu/ops/adc.py (bf16 tables, f32 sums).
2. The probe-scan ADC search: residual and plain, ip and l2.
3. Refine: residual (ip, l2) and whole-row rows, with and without OPQ.
4. ``merge_from`` with ``id_offset``, ``remove``, ``reconstruct``.
5. Persistence both ways.
6. Unfilled slots: the port returns (-inf, -1); the reference returns the
   id of arena row 0 there, recorded beside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.index import load_index as jax_load_index
from cloudvectordb_tpu.index.ivf_pq import IVFPQIndex as JaxIVFPQIndex
from cloudvectordb_tpu.index.ivf_pq import _build_luts as jax_build_luts
from cloudvectordb_tpu.ops.adc import adc_scan as jax_adc_scan
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.index.ivf_pq import IVFPQIndex, _build_luts
from cloudvectordb_tpu_torch.index.registry import load_index
from cloudvectordb_tpu_torch.ops.adc import adc_scan

D, NLIST, M, NBITS, K = 32, 16, 8, 6, 10
ADC_TOL, F32_TOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(3000, D, n_clusters=24, seed=130, normalize=True)
    q = queries_from(db, 40, seed=131, normalize=True)
    return db, q


@pytest.fixture(scope="module")
def opq_matrix():
    rng = np.random.default_rng(132)
    return np.linalg.qr(rng.normal(size=(D, D)))[0].astype(np.float32)


def make_pair(db, *, rows=None, j_quant=None, **kw):
    """(reference, port) over ``rows`` (default all of db) on the same
    quantizers: the reference trains them (or takes ``j_quant``'s), the port
    takes the reference's."""
    rows = db if rows is None else rows
    j = JaxIVFPQIndex(D, NLIST, m=M, nbits=NBITS, kmeans_iters=5, pq_train_iters=5, **kw)
    if j_quant is None:
        j.train(db[:2000])
    else:
        j.centroids, j.codebooks = j_quant.centroids, j_quant.codebooks
    t = IVFPQIndex(D, NLIST, m=M, nbits=NBITS, device="cpu", **kw)
    t.train(None, centroids=j.centroids, codebooks=j.codebooks)
    j.add(rows)
    j.merge_pending()
    t.add(rows)
    t.merge_pending()
    return j, t


def assert_same(vt, it, vj, ij, tol):
    vj, ij = np.asarray(vj), np.asarray(ij)
    filled = np.isfinite(vj)
    assert np.array_equal(filled, np.isfinite(vt))
    np.testing.assert_allclose(vt[filled], vj[filled], atol=tol, rtol=0)
    same = it == ij
    differ = ~same & filled
    assert same[filled].mean() >= 0.99 and np.all(np.abs(vt[differ] - vj[differ]) <= tol)


def assert_same_refine_rows(t, j):
    a = np.asarray(j._refine_rows).astype(np.int16)
    b = t._refine_rows.astype(np.int16)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.9999
    assert t._refine_scale == pytest.approx(j._refine_scale, rel=1e-6)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_build_luts(data, metric):
    _, q = data
    cb = np.random.default_rng(133).normal(size=(M, 2 ** NBITS, D // M)).astype(np.float32)
    want = np.asarray(jax_build_luts(jnp.asarray(q), jnp.asarray(cb), metric))
    got = _build_luts(torch.from_numpy(q), torch.from_numpy(cb), metric).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("n, tile", [(2000, 512), (777, 16384)])
def test_adc_scan_is_the_reference(data, n, tile):
    """Ragged tiles (2000 rows in tiles of 512) and one tile past N."""
    db, q = data
    rng = np.random.default_rng(134)
    codes = rng.integers(0, 2 ** NBITS, size=(n, M), dtype=np.uint8)
    luts = rng.normal(size=(q.shape[0], M, 2 ** NBITS)).astype(np.float32)
    vj, ij = jax_adc_scan(jnp.asarray(codes), jnp.asarray(luts), k=K, tile=tile)
    vt, it = adc_scan(torch.from_numpy(codes), torch.from_numpy(luts), K, tile=tile)
    assert_same(vt.numpy(), it.numpy(), vj, ij, ADC_TOL)
    vt, _ = adc_scan(torch.from_numpy(codes[:5]), torch.from_numpy(luts), K)
    assert vt.shape == (q.shape[0], 5)  # k = min(k, n)


@pytest.mark.parametrize("metric, residual", [("ip", True), ("ip", False), ("l2", True),
                                              ("l2", False)])
def test_adc_probe_scan(data, metric, residual):
    db, q = data
    j, t = make_pair(db, metric=metric, residual=residual)
    np.testing.assert_array_equal(t._arena.payload, np.asarray(j._arena.payload))
    np.testing.assert_array_equal(t._arena.ids, np.asarray(j._arena.ids))
    for nprobe in (2, NLIST):
        vt, it = t.search(q, K, nprobe=nprobe)
        assert_same(vt, it, *j.search(q, K, nprobe=nprobe), ADC_TOL)


@pytest.mark.parametrize("metric, residual, opq", [("ip", True, False), ("l2", True, False),
                                                   ("ip", False, False), ("ip", True, True),
                                                   ("ip", False, True)])
def test_refine(data, opq_matrix, metric, residual, opq):
    """Residual refine rows (rotated residuals) and whole-row ones
    (unrotated rows against the raw queries), with and without OPQ."""
    db, q = data
    kw = dict(metric=metric, residual=residual, refine="int8",
              opq_matrix=opq_matrix if opq else None)
    j, t = make_pair(db, **kw)
    assert t._refine_residual == j._refine_residual == residual
    assert_same_refine_rows(t, j)
    for nprobe, rf in ((4, 16), (NLIST, 4)):
        vt, it = t.search(q, K, nprobe=nprobe, refine_factor=rf)
        assert_same(vt, it, *j.search(q, K, nprobe=nprobe, refine_factor=rf), F32_TOL)
    _, gt = brute_force_topk(db, q, K, metric=metric)
    assert recall_at_k(t.search(q, K, nprobe=NLIST, refine_factor=16)[1], gt) >= 0.9
    ids = np.arange(0, 3000, 37)
    np.testing.assert_allclose(t.reconstruct(ids), j.reconstruct(ids), atol=1e-5, rtol=0)


def test_merge_from_and_remove(data):
    db, q = data
    j, t = make_pair(db, rows=db[:2048], refine="int8")
    jb, tb = make_pair(db, rows=db[2048:], j_quant=j, refine="int8")
    assert t.merge_from(tb, id_offset=2048) == j.merge_from(jb, id_offset=2048) == 952
    np.testing.assert_array_equal(t._arena.payload, np.asarray(j._arena.payload))
    np.testing.assert_array_equal(t._arena.ids, np.asarray(j._arena.ids))
    np.testing.assert_array_equal(t._arena.offsets, j._arena.offsets)
    assert_same_refine_rows(t, j)
    assert t._next_id == j._next_id == 3000
    vt, it = t.search(q, K, nprobe=NLIST)
    assert_same(vt, it, *j.search(q, K, nprobe=NLIST), F32_TOL)
    with pytest.raises(AssertionError):  # the same ids again collide
        t.merge_from(tb)
    ids = np.arange(2000, 2100)
    np.testing.assert_allclose(t.reconstruct(ids), j.reconstruct(ids), atol=1e-5, rtol=0)
    victims = np.arange(0, 3000, 5)
    assert t.remove(victims) == j.remove(victims) == 600
    vt, it = t.search(q, K, nprobe=8)
    assert_same(vt, it, *j.search(q, K, nprobe=8), F32_TOL)
    assert not np.isin(it, victims).any()
    with pytest.raises(KeyError):
        t.reconstruct(victims[:3])


def test_persistence_both_ways(data, opq_matrix, tmp_path):
    db, q = data
    j, t = make_pair(db, refine="int8", opq_matrix=opq_matrix)
    t._op_point = {"nprobe": 4, "refine_factor": 16}
    t.save(tmp_path / "port")
    jl = jax_load_index(tmp_path / "port")
    assert jl.kind == "ivf_pq" and jl._refine_residual and jl.opq_matrix is not None
    j.save(tmp_path / "ref")
    tl = load_index(tmp_path / "ref", device="cpu")
    assert isinstance(tl, IVFPQIndex) and tl.refine == "int8" and tl._refine_residual
    vt, it = tl.search(q, K, nprobe=4)
    st = tl._dev
    np.testing.assert_array_equal(it, tl.search(q, K, nprobe=4)[1])
    assert tl._dev is st  # nothing pending: search keeps the device copies
    np.testing.assert_array_equal(it, t.search(q, K)[1])  # the port's op point persisted
    assert load_index(tmp_path / "port", device="cpu")._op_point == t._op_point
    assert_same(vt, it, *jl.search(q, K, nprobe=4), F32_TOL)


@pytest.mark.parametrize("refine", ["none", "int8"])
def test_unfilled_slots(data, refine):
    """k beyond the probed rows: the port's tail is (-inf, -1); the
    reference's is (-inf, the id of arena row 0), a real id (ROADMAP queue
    3)."""
    db, q = data
    j, t = make_pair(db, rows=db[:200], refine=refine)
    k = 150
    vj, ij = (np.asarray(a) for a in j.search(q[:4], k, nprobe=1, refine_factor=1))
    vt, it = t.search(q[:4], k, nprobe=1, refine_factor=1)
    filled = np.isfinite(vt)
    assert (~filled).any() and np.array_equal(filled, np.isfinite(vj))
    assert np.all(it[~filled] == -1) and np.all(ij[~filled] == int(j._arena.ids[0]))
    assert_same(vt, it, vj, ij, ADC_TOL)
