"""Filtered, l2, top-2 and 'precise' search on the residual-int8
BandIVFIndex, held to the reference on the same state.

1. ``IdFilter`` (its three accepted forms), ``_plan_tiles(tile_live=)`` and
   ``_arena_mask_from_ids`` against the reference's: masks, tile tables and
   arena masks equal outright.
2. The index carried across (``from_state``) and searched with ``where=``
   by both packages: a 50% filter at full coverage, a filter of five ids
   (whose tails are (-inf, -1)), a filter correlated with two lists under a
   budget too small for blind planning; ids equal on >= 99% of slots and
   every mismatch a near-tie (scores within 1e-4), no disallowed id, recall
   against the restricted exact top-k; ``search_device`` equal to
   ``search``; the mask cache misses after an in-place write to the ids.
3. ``filtered_search`` over ``FlatIndex`` against the reference's.
4. ``metric='l2'`` on unnormalised rows: the same state as an l2 index in
   both packages (the build never reads the metric), ids as in 2, scores
   -‖q - x̂‖² within 2e-4 (keys of ~40, where f32 steps are 4e-6), recall
   against the exact l2 top-k; saved by either package, loaded by the other.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.index import filters as jax_filters
from cloudvectordb_tpu.index import ivf_band as jax_band
from cloudvectordb_tpu.index.flat import FlatIndex as JaxFlatIndex
from cloudvectordb_tpu.index.registry import load_index as jax_load_index
from cloudvectordb_tpu_torch.eval.recall import recall_at_k
from cloudvectordb_tpu_torch.index import filters
from cloudvectordb_tpu_torch.index.flat import FlatIndex
from cloudvectordb_tpu_torch.index.ivf_band import (
    BandIVFIndex, _arena_mask_from_ids, _plan_tiles)
from cloudvectordb_tpu_torch.index.registry import load_index

KW = dict(nlist=16, dtype="int8", residual=True, kmeans_iters=6, tile_n=256, tile_q=16)
TOL = 1e-4


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4000, 64, n_clusters=32, seed=150, normalize=True)
    q = queries_from(db, 48, seed=151, normalize=True)
    return db, q


@pytest.fixture(scope="module")
def pair(data):
    """(port index, reference index) on one state."""
    j = jax_band.BandIVFIndex.build(data[0], **KW)
    return BandIVFIndex.from_state(j._state_meta(), j._state_arrays(), device="cpu"), j


def _oracle(db, q, k, allowed=None, metric="ip"):
    """Exact top-k ids, restricted to allowed rows."""
    s = q @ db.T if metric == "ip" else -((q[:, None, :] - db[None]) ** 2).sum(2)
    if allowed is not None:
        s = np.where(allowed[None, :], s, -np.inf)
    return np.argsort(-s, axis=1, kind="stable")[:, :k]


def _assert_same(vt, it, vj, ij, tol=TOL):
    vj, ij = np.asarray(vj), np.asarray(ij).astype(np.int64)
    live = np.isfinite(vj)
    np.testing.assert_array_equal(np.isfinite(vt), live)
    np.testing.assert_array_equal(it[~live], ij[~live])  # unfilled: (-inf, -1) in both
    np.testing.assert_allclose(vt[live], vj[live], atol=tol, rtol=0)
    same = it == ij
    assert same.mean() >= 0.99, same.mean()
    assert np.all(np.abs(vt[~same & live] - vj[~same & live]) <= tol)


def _p_all(idx):
    return int(idx._payload.shape[0]) // idx.tile_n


def test_idfilter_coerce_forms_match_reference():
    mask = np.zeros(100, bool)
    mask[[3, 7, 50]] = True
    g = np.array([3, 7, 50, 4, -1, 10_000])
    exp = np.array([True, True, True, False, False, False])
    for where in (mask, np.array([3, 7, 50]), mask.astype(np.uint8)):
        f, fj = filters.IdFilter.coerce(where, 100), jax_filters.IdFilter.coerce(where, 100)
        np.testing.assert_array_equal(f.mask_np, fj.mask_np)
        np.testing.assert_array_equal(f.allowed_np(g), exp)
        assert f.n_allowed == fj.n_allowed == 3
        assert filters.IdFilter.coerce(f, 100) is f
        np.testing.assert_array_equal(f.allowed_dev(torch.from_numpy(g)).numpy(), exp)
        assert f.mask_device("cpu").dtype == torch.int8
    f = filters.IdFilter.coerce(np.array([5, 2000]), 100)  # gids past the bound widen it
    assert f.mask_np.shape[0] == 2048 and f.allowed_np(np.array([2000]))[0]
    with pytest.raises(TypeError):
        filters.IdFilter.coerce(np.array([0.5]), 100)
    # on a serving mesh: the bitmap on each of its devices, mask_device's copy
    from cloudvectordb_tpu_torch.parallel.mesh import make_mesh

    staged = f.staged_for_mesh(make_mesh(4, devices=["cpu"]))
    assert list(staged) == [torch.device("cpu")]
    assert staged[torch.device("cpu")] is f.mask_device("cpu")


def test_plan_tiles_tile_live_and_arena_mask_match_reference(pair):
    t, j = pair
    rng = np.random.default_rng(3)
    q = rng.normal(size=(64, 64)).astype(np.float32)
    ids = np.asarray(j._ids[: j._n], np.int32).copy()
    ids[::7] = -1  # holes
    allowed = np.zeros(4096, np.int8)
    allowed[rng.choice(4000, 5, replace=False)] = 1  # at most 5 of 16 tiles live
    n_pad = int(j._payload.shape[0])
    rm_j = np.asarray(jax_band._arena_mask_from_ids(jnp.asarray(ids), jnp.asarray(allowed),
                                                    n_pad=n_pad))
    rm = _arena_mask_from_ids(torch.from_numpy(ids), torch.from_numpy(allowed), n_pad=n_pad)
    assert rm.shape == (1, n_pad) and rm.dtype == torch.int8
    np.testing.assert_array_equal(rm.numpy(), rm_j)
    live = rm_j[0].reshape(-1, t.tile_n).max(axis=1) > 0
    assert 0 < live.sum() < live.size
    for p in (2, int(live.sum()) + 2):
        _, _, _, tt_j = jax_band._plan_tiles(jnp.asarray(q), jnp.asarray(j.centroids),
                                             jnp.asarray(j._tile_window), 16, p,
                                             tile_live=jnp.asarray(live))
        _, _, _, tt = _plan_tiles(torch.from_numpy(q), torch.from_numpy(j.centroids),
                                  torch.from_numpy(j._tile_window).long(), 16, p,
                                  tile_live=torch.from_numpy(live))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tt_j))


def test_filtered_half_at_full_coverage(data, pair):
    db, q = data
    t, j = pair
    mask = np.random.default_rng(0).random(db.shape[0]) < 0.5
    vt, it = t.search(q, 10, p_tiles=_p_all(t), where=mask)
    vj, ij = j.search(q, 10, p_tiles=_p_all(t), where=mask)
    _assert_same(vt, it, vj, ij)
    assert mask[it[it >= 0]].all(), "disallowed id returned"
    assert recall_at_k(it, _oracle(db, q, 10, mask)) >= 0.9
    assert not (t.search(q, 10, p_tiles=_p_all(t))[1] == it).all()  # the filter bit


def test_filtered_low_selectivity_tails(data, pair):
    t, j = pair
    allowed = np.array([11, 222, 1333, 2444, 3555])
    vt, it = t.search(data[1], 10, p_tiles=_p_all(t), where=allowed)
    vj, ij = j.search(data[1], 10, p_tiles=_p_all(t), where=allowed)
    _assert_same(vt, it, vj, ij)
    assert set(it[it >= 0].ravel()) <= set(allowed.tolist())
    assert (it[:, 5:] == -1).all() and np.isneginf(vt[:, 5:]).all()


def test_filtered_correlated_selectivity_planning(data, pair):
    """All allowed rows in two lists: the tiles with none leave the plan,
    so a budget far too small for blind planning covers every live tile."""
    db, q = data
    t, j = pair
    lists = np.repeat(np.arange(t.nlist), np.diff(t._offsets))
    ids = np.asarray(t._ids[: t._n], np.int64)
    allowed = ids[np.isin(lists, [3, 11]) & (ids >= 0)]
    assert 100 < allowed.size < 1500
    mask = np.zeros(db.shape[0], bool)
    mask[allowed] = True
    p_small = max(2, int(np.ceil(allowed.size / t.tile_n)) + 2)
    assert p_small < _p_all(t) // 2
    vt, it = t.search(q, 10, p_tiles=p_small, where=mask)
    vj, ij = j.search(q, 10, p_tiles=p_small, where=mask)
    _assert_same(vt, it, vj, ij)
    assert mask[it[it >= 0]].all()
    assert recall_at_k(it, _oracle(db, q, 10, mask)) >= 0.9


def test_filtered_search_device_matches_search_and_caches(data, pair):
    db, q = data
    t, _ = pair
    flt = t.make_filter(np.random.default_rng(1).random(db.shape[0]) < 0.3)
    v_h, i_h = t.search(q, 10, p_tiles=_p_all(t), where=flt)
    n_cached = len(t._flt_cache)
    v_d, i_d = t.search_device(torch.from_numpy(q), 10, p_tiles=_p_all(t), where=flt)
    assert len(t._flt_cache) == n_cached  # the second call hit the cache
    assert i_d.dtype == torch.int32
    np.testing.assert_array_equal(v_d.numpy(), v_h)
    np.testing.assert_array_equal(i_d.numpy(), i_h)


def test_mask_cache_misses_after_in_place_ids_write(data):
    """An in-place write keeps the ids tensor's identity; its version
    moves, so the cached arena mask is rebuilt and the written row obeys
    the filter at once."""
    db, q = data
    t = BandIVFIndex.build(db, centroids=None, device="cpu", **KW)
    flt = t.make_filter(np.ones(db.shape[0], bool))
    _, i0 = t.search(q[:4], 1, p_tiles=_p_all(t), where=flt)
    rows = np.flatnonzero(np.asarray(t._ids[: t._n]) == i0[0, 0])
    ids_t = t._device_state()["ids"]
    ids_t[int(rows[0])] = -1  # the row becomes a hole: disallowed
    _, i1 = t.search(q[:4], 1, p_tiles=_p_all(t), where=flt)
    assert i1[0, 0] != i0[0, 0]
    assert len(t._flt_cache) == 2


def test_whole_row_where_refused_and_filtered_search_flat(data):
    db, q = data
    mask = np.random.default_rng(2).random(db.shape[0]) < 0.4
    whole = BandIVFIndex.build(db, nlist=16, kmeans_iters=2, tile_n=256, tile_q=16,
                               device="cpu")
    for call in (lambda: whole.search(q, 10, where=mask),
                 lambda: whole.search(q, 10, where=mask, strategy="band")):
        with pytest.raises(ValueError, match="filtered_search"):
            call()
    vt, it = filters.filtered_search(FlatIndex.build(db, device="cpu"), q, 10, where=mask,
                                     oversample=64)
    vj, ij = jax_filters.filtered_search(JaxFlatIndex.build(db), q, 10, where=mask,
                                         oversample=64)
    _assert_same(vt, it, vj, ij, tol=1e-5)
    assert mask[it[it >= 0]].all()
    assert recall_at_k(it, _oracle(db, q, 10, mask)) >= 0.97


@pytest.fixture(scope="module")
def l2_data():
    """Clustered rows with a 6x per-row norm spread: ip and l2 rank differently."""
    x = clustered_vectors(4000, 64, n_clusters=24, seed=400, normalize=True)
    db = (x * np.random.default_rng(401).uniform(0.5, 3.0, (4000, 1))).astype(np.float32)
    q = db[:32] + 0.05 * np.random.default_rng(402).standard_normal((32, 64)).astype(
        np.float32)
    j = jax_band.BandIVFIndex.build(db, metric="l2", **KW)
    return db, q, j


def test_resid_l2_matches_reference(l2_data):
    db, q, j = l2_data
    t = BandIVFIndex.from_state(j._state_meta(), j._state_arrays(), device="cpu",
                                metric="l2")
    vt, it = t.search(q, 10, p_tiles=_p_all(t))
    vj, ij = j.search(q, 10, p_tiles=_p_all(t))
    _assert_same(vt, it, vj, ij, tol=2e-4)
    gt = _oracle(db, q, 10, metric="l2")
    assert recall_at_k(it, gt) >= 0.9
    ip = BandIVFIndex.from_state(j._state_meta(), j._state_arrays(), device="cpu")
    assert recall_at_k(ip.search(q, 10, p_tiles=_p_all(t))[1], gt) < recall_at_k(it, gt) - 0.15
    assert (vt <= 0).all()  # -‖q - x̂‖²
    # filtered l2: the reference's restricted answers, no disallowed id
    mask = np.random.default_rng(5).random(4000) < 0.5
    vt, it = t.search(q, 10, p_tiles=_p_all(t), where=mask, top2=True)
    vj, ij = j.search(q, 10, p_tiles=_p_all(t), where=mask, top2=True)
    _assert_same(vt, it, vj, ij, tol=2e-4)
    assert mask[it[it >= 0]].all()
    v_d, i_d = t.search_device(torch.from_numpy(q), 10, p_tiles=_p_all(t), where=mask,
                               top2=True)
    np.testing.assert_array_equal(i_d.numpy(), it)
    np.testing.assert_array_equal(v_d.numpy(), vt)


def test_resid_l2_artifacts_load_both_ways(l2_data, tmp_path):
    db, q, j = l2_data
    j.save(tmp_path / "jax_l2")
    t = load_index(tmp_path / "jax_l2", device="cpu")
    assert t.metric == "l2"
    vt, it = t.search(q, 10, p_tiles=8)
    vj, ij = j.search(q, 10, p_tiles=8)
    _assert_same(vt, it, vj, ij, tol=2e-4)
    t.save(tmp_path / "port_l2")
    assert json.loads((tmp_path / "port_l2" / "manifest.json").read_text())["metric"] == "l2"
    j2 = jax_load_index(tmp_path / "port_l2")
    assert j2.metric == "l2"
    np.testing.assert_array_equal(np.asarray(j2.search(q, 10, p_tiles=8)[1]), ij)
    t2 = load_index(tmp_path / "port_l2", device="cpu")
    np.testing.assert_array_equal(t2.search(q, 10, p_tiles=8)[1], it)
