"""FlatIndex end to end: the port against the reference's FlatIndex on the
same vectors.

1. ``search`` with ``exact=None`` (the exact scan off a CUDA device, as the
   reference off a TPU) and ``exact=True``; ``exact=False`` (the fused K2
   scan's plain version) against the reference's fused scan in interpret
   mode on the same store.
2. ``add`` widening the int8 scale (the store requantized), ``remove`` with
   ids mapped back to the originals, ``reconstruct``.
3. State carried across (``from_state``) and artifacts loading in both
   directions for the f32 and int8 stores; bf16 stores load in the port
   from either package. (The reference cannot reload its own bf16
   artifact: it saves ml_dtypes bf16 as a two-byte void ``.npy``, which
   ``jnp.asarray`` refuses; ROADMAP.md §3.)

Tolerances: scores within 1e-5 absolute (f32 sums in another order); ids
equal except at near-ties (scores within 1e-5). int8 stores: the scale
within 1e-6 relative (an f32 mean summed in another order), codes within
one step on >= 99.99% of bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.index import load_index as jax_load_index
from cloudvectordb_tpu.index.flat import FlatIndex as JaxFlatIndex
from cloudvectordb_tpu.ops.pallas_topk import flat_topk_pallas, flat_topk_pallas_int8
from cloudvectordb_tpu_torch.index.flat import FlatIndex
from cloudvectordb_tpu_torch.index.registry import load_index

TOL = 1e-5
STORES = [("float32", "ip"), ("float32", "l2"), ("bfloat16", "ip"),
          ("bfloat16", "l2"), ("int8", "ip")]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(40)
    db = (rng.normal(size=(5000, 48)) / np.sqrt(48)).astype(np.float32)
    q = (rng.normal(size=(30, 48)) / np.sqrt(48)).astype(np.float32)
    return db, q


def _assert_agree(sj, ij, st, it):
    np.testing.assert_allclose(st, sj, atol=TOL, rtol=0)
    same = it == np.asarray(ij)
    assert np.all(np.abs(st - sj)[~same] <= TOL)
    assert same.mean() >= 0.99, same.mean()


def _assert_same_store(t, j):
    vj = np.asarray(jnp.asarray(j._vecs).astype(jnp.float32))
    vt = t._vecs.float().numpy()
    assert vj.shape == vt.shape
    if t.dtype == "int8":
        assert t._scale == pytest.approx(j._scale, rel=1e-6)
        diff = np.abs(vj - vt)
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.9999
    else:
        np.testing.assert_array_equal(vt, vj)


@pytest.mark.parametrize("exact", [None, True], ids=["exact_None", "exact_True"])
@pytest.mark.parametrize("dtype,metric", STORES)
def test_search_matches_reference(data, dtype, metric, exact):
    db, q = data
    j = JaxFlatIndex.build(db, metric=metric, dtype=dtype)
    t = FlatIndex.build(db, metric=metric, dtype=dtype)
    _assert_same_store(t, j)
    _assert_agree(*j.search(q, 10, exact=exact), *t.search(q, 10, exact=exact))


@pytest.mark.parametrize("dtype,metric", STORES)
def test_fused_search_matches_reference_fused_scan(data, dtype, metric):
    """exact=False: the K2 scan (its plain version here) on the port's store
    against the reference's fused scan on the reference's store."""
    db, q = data
    j = JaxFlatIndex.build(db, metric=metric, dtype=dtype)
    t = FlatIndex.build(db, metric=metric, dtype=dtype)
    if dtype == "int8":
        scale = jnp.float32(j._scale)
        sj, ij = flat_topk_pallas_int8(j._vecs, j._scale, (jnp.asarray(q) * scale) / scale,
                                       10, interpret=True)
    else:
        sj, ij = flat_topk_pallas(j._vecs, jnp.asarray(q), 10, metric=metric,
                                  db_sqnorms=j._sqnorms if metric == "l2" else None,
                                  interpret=True)
    st, it = t.search(q, 10, exact=False)
    if dtype == "int8":  # same codes -> the same exact int32 top-k
        np.testing.assert_array_equal(it, np.asarray(ij))
        np.testing.assert_allclose(st, np.asarray(sj), rtol=3e-7, atol=0)
    else:
        _assert_agree(np.asarray(sj), ij, st, it)


def test_int8_add_widens_the_scale(data):
    db, q = data
    j = JaxFlatIndex(48, dtype="int8")
    t = FlatIndex(48, dtype="int8")
    for part in (db[:2000] * 0.5, db[2000:]):  # the second batch is wider
        j.add(part)
        t.add(part)
    assert t._scale > 0 and t.ntotal == j.ntotal == 5000
    _assert_same_store(t, j)
    _assert_agree(*j.search(q, 10), *t.search(q, 10))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_remove_maps_ids_back_and_reconstructs(data, dtype):
    db, q = data
    j = JaxFlatIndex.build(db, dtype=dtype)
    t = FlatIndex.build(db, dtype=dtype)
    _, top = t.search(q, 10)
    gone = np.concatenate([top[:, 0], [-1, 10**9, 7, 7]])  # holes and unknowns ignored
    assert t.remove(gone) == j.remove(gone) > 0
    assert t.remove([]) == 0
    sj, ij = j.search(q, 10)
    st, it = t.search(q, 10)
    _assert_agree(sj, ij, st, it)
    assert not np.isin(it, gone).any()
    t.add(db[:3])  # new ids continue after the largest ever issued
    j.add(db[:3])
    np.testing.assert_array_equal(t._ids, j._ids)
    keep = t._ids[[0, 5, -1]]
    np.testing.assert_allclose(t.reconstruct(keep), j.reconstruct(keep), rtol=1e-6, atol=0)
    with pytest.raises(KeyError):
        t.reconstruct(gone[:1])


def test_reconstruct_bf16(data):
    db, _ = data
    j = JaxFlatIndex.build(db, dtype="bfloat16")
    t = FlatIndex.build(db, dtype="bfloat16")
    np.testing.assert_array_equal(t.reconstruct([0, 17, 4999]), j.reconstruct([0, 17, 4999]))


@pytest.mark.parametrize("dtype,metric", [("float32", "l2"), ("int8", "ip")])
def test_artifacts_load_both_ways(data, dtype, metric, tmp_path):
    db, q = data
    j = JaxFlatIndex.build(db, metric=metric, dtype=dtype)
    j.remove([3, 4])
    j.save(tmp_path / "jax")
    t = load_index(tmp_path / "jax")
    assert isinstance(t, FlatIndex) and t.metric == metric
    np.testing.assert_array_equal(t._vecs.float().numpy(),
                                  np.asarray(j._vecs).astype(np.float32))
    assert t._scale == j._scale and t._next_id == 5000
    _assert_agree(*j.search(q, 10), *t.search(q, 10))
    t.save(tmp_path / "port")
    j2 = jax_load_index(tmp_path / "port")
    np.testing.assert_array_equal(np.asarray(j2._vecs), np.asarray(j._vecs))
    np.testing.assert_array_equal(j2._ids, j._ids)
    _assert_agree(*j2.search(q, 10), *t.search(q, 10))
    t2 = FlatIndex.from_state(j._state_meta(), j._state_arrays(), metric=metric)
    np.testing.assert_array_equal(t2.search(q, 10)[1], t.search(q, 10)[1])


def test_bf16_store_loads_in_the_port(data, tmp_path):
    db, q = data
    j = JaxFlatIndex.build(db, metric="l2", dtype="bfloat16")
    j.save(tmp_path / "jax")
    t = load_index(tmp_path / "jax")
    assert t._vecs.dtype == torch.bfloat16
    np.testing.assert_array_equal(t._vecs.float().numpy(),
                                  np.asarray(j._vecs.astype(jnp.float32)))
    t.save(tmp_path / "port")
    t2 = load_index(tmp_path / "port")
    assert torch.equal(t2._vecs, t._vecs) and torch.equal(t2._sqnorms, t._sqnorms)
    _assert_agree(*j.search(q, 10), *t2.search(q, 10))


def test_refused_options_raise():
    with pytest.raises(ValueError):
        FlatIndex(8, metric="l2", dtype="int8")
    with pytest.raises(ValueError):
        FlatIndex(8, dtype="float16")
    with pytest.raises(ValueError):
        FlatIndex(8).add(np.zeros((2, 9), np.float32))
