"""The whole-row BandIVFIndex (int8, bf16 and f32 arenas, residual=False):
the port held to the reference on the same data and the same quantizer.

1. Layout parity from the same ordered centroids (``build`` for every
   dtype, ``build_device_streaming`` for int8): offsets, ids and
   tile_window exact; the arena equal byte for byte (int8, whose scale is
   equal too) or exactly (bf16, f32).
2. Search: the tiles strategy with scoring 'int8', 'hybrid' and 'precise',
   and the band strategy; ids equal on >= 99% of slots, every mismatch a
   near-tie (scores within 1e-5), recall@10 against the exact top-k within
   0.005 of the reference's; ``search_device`` equal to ``search``.
3. Artifacts load in both directions (int8 and f32 arenas; bf16 in the
   port), ``from_state`` carries the reference's state, ``tune`` meets its
   target, and what the reference refuses is refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.index import load_index as jax_load_index
from cloudvectordb_tpu.index.ivf_band import BandIVFIndex as JaxBandIVFIndex
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex
from cloudvectordb_tpu_torch.index.registry import load_index

KW = dict(nlist=16, kmeans_iters=6, tile_n=256, tile_q=16)
TOL = 1e-5


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4000, 64, n_clusters=32, seed=80, normalize=True)
    q = queries_from(db, 48, seed=81, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    return db, q, gt


@pytest.fixture(scope="module")
def jidx(data):
    return {dt: JaxBandIVFIndex.build(data[0], dtype=dt, **KW)
            for dt in ("int8", "bfloat16", "float32")}


def _assert_same_layout(t, j):
    np.testing.assert_array_equal(t._offsets, j._offsets)
    np.testing.assert_array_equal(t._ids, np.asarray(j._ids))
    np.testing.assert_array_equal(t._tile_window, j._tile_window)
    assert t._n == j._n and t.ntotal == j.ntotal and t._scale == j._scale
    pj = np.asarray(jnp.asarray(j._payload).astype(jnp.float32))
    np.testing.assert_array_equal(t._payload.float().cpu().numpy(), pj)
    assert t._payload.dtype == {"int8": torch.int8, "bfloat16": torch.bfloat16,
                                "float32": torch.float32}[t.dtype]


def _assert_same_search(t, j, q, gt, **kw):
    vj, ij = j.search(q, 10, **kw)
    vt, it = t.search(q, 10, **kw)
    np.testing.assert_allclose(vt, vj, atol=TOL, rtol=0)
    same = it == ij
    assert same.mean() >= 0.99, (kw, same.mean())
    assert np.all(np.abs(vt - vj)[~same] <= TOL)
    assert abs(recall_at_k(it, gt) - recall_at_k(ij, gt)) <= 0.005


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_layout_and_search_parity(data, jidx, dtype):
    db, q, gt = data
    j = jidx[dtype]
    t = BandIVFIndex.build(db, centroids=j.centroids, dtype=dtype, device="cpu", **KW)
    _assert_same_layout(t, j)
    for scoring in ("hybrid", "int8", "precise"):
        _assert_same_search(t, j, q, gt, p_tiles=8, scoring=scoring)
    _assert_same_search(t, j, q, gt, p_tiles=t._tune_n_tiles())
    _assert_same_search(t, j, q, gt)  # the auto budget
    _assert_same_search(t, j, q, gt, strategy="band")
    _assert_same_search(t, j, q[:5], gt[:5], strategy="band", nprobe=4)


def test_layout_parity_device_streaming(data):
    db, q, gt = data
    kw = dict(KW, train_sample=1000)
    j = JaxBandIVFIndex.build_device_streaming(
        lambda i: jnp.asarray(db[i * 1000:(i + 1) * 1000]), 4, **kw)
    t = BandIVFIndex.build_device_streaming(
        lambda i: torch.from_numpy(db[i * 1000:(i + 1) * 1000]), 4,
        centroids=j.centroids, device="cpu", **kw)
    assert not t.residual and t._list_lens is None
    _assert_same_layout(t, j)
    for scoring in ("hybrid", "int8"):
        _assert_same_search(t, j, q, gt, p_tiles=8, scoring=scoring)
    _assert_same_search(t, j, q, gt, strategy="band")


def test_search_device_matches_search(data, jidx):
    _, q, _ = data
    j = jidx["int8"]
    t = BandIVFIndex.from_state(j._state_meta(), j._state_arrays(), device="cpu")
    q45 = q[:45]  # not a tile_q multiple: padded by repeating the last query
    for scoring in ("hybrid", "int8"):
        v_h, i_h = t.search(q45, 10, p_tiles=8, scoring=scoring)
        v_d, i_d = t.search_device(torch.from_numpy(q45), 10, p_tiles=8, scoring=scoring)
        assert i_d.dtype == torch.int32 and v_d.shape == (45, 10)
        np.testing.assert_array_equal(i_d.numpy(), i_h)
        np.testing.assert_array_equal(v_d.numpy(), v_h)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_artifacts_load_both_ways(data, jidx, dtype, tmp_path):
    db, q, gt = data
    j = jidx[dtype]
    j.save(tmp_path / "jax")
    t = load_index(tmp_path / "jax", device="cpu")
    _assert_same_layout(t, j)
    _assert_same_search(t, j, q, gt, p_tiles=8)
    t._op_point = {"p_tiles": 8, "tile_q": 16}
    t.save(tmp_path / "port")
    j2 = jax_load_index(tmp_path / "port")
    _assert_same_layout(t, j2)
    assert j2._op_point == t._op_point
    _assert_same_search(t, j2, q, gt)  # both serve the saved op point


def test_bf16_arena_round_trips_in_the_port(data, jidx, tmp_path):
    db, q, gt = data
    t = BandIVFIndex.from_state(jidx["bfloat16"]._state_meta(),
                                jidx["bfloat16"]._state_arrays(), device="cpu")
    _assert_same_layout(t, jidx["bfloat16"])
    t.save(tmp_path / "port")
    t2 = load_index(tmp_path / "port", device="cpu")
    assert torch.equal(t2._payload, t._payload)
    np.testing.assert_array_equal(t2.search(q, 10, p_tiles=8)[1], t.search(q, 10, p_tiles=8)[1])


def test_tune_picks_a_passing_op_point(data, jidx):
    db, q, gt = data
    t = BandIVFIndex.from_state(jidx["int8"]._state_meta(), jidx["int8"]._state_arrays(),
                                device="cpu")
    report = t.tune(q, k=10, target_recall=0.95)
    assert report["met"] and t._op_point == report["op"]
    assert recall_at_k(t.search(q, 10)[1], gt) >= 0.85


def test_refused_and_unported_options(data, jidx):
    db, q, _ = data
    with pytest.raises(ValueError):  # the reference refuses whole-row l2
        BandIVFIndex(64, 16, metric="l2", device="cpu")
    with pytest.raises(ValueError):
        BandIVFIndex(64, 16, dtype="float32", residual=True, device="cpu")
    with pytest.raises(ValueError):
        BandIVFIndex(64, 16, dtype="float32", slack=0.5, device="cpu")
    with pytest.raises(ValueError):  # device streaming is the int8 path
        BandIVFIndex.build_device_streaming(lambda i: torch.from_numpy(db[:500]), 1,
                                            nlist=4, dtype="float32", device="cpu")
    t = BandIVFIndex.from_state(jidx["int8"]._state_meta(), jidx["int8"]._state_arrays(),
                                device="cpu")
    with pytest.raises(NotImplementedError):
        t.search(q, 10, top2=True)
    with pytest.raises(ValueError):
        t.search(q, 10, strategy="bands")
    resid = BandIVFIndex.build(db, residual=True, device="cpu", **KW)
    with pytest.raises(ValueError):  # the band scan has no centroid term
        resid.search(q, 10, strategy="band")
