"""The residual-int8 BandIVFIndex: the port held to the reference on the same
data and the same quantizer.

1. Layout parity from the same ordered centroids (build, device-streaming
   build, and a build whose tile-span cap pads holes): offsets, ids,
   tile_window, local, valid_end and centroid tiles exact; the int8 arena
   equal on >= 99.99% of bytes with max |Δ| <= 1 (the residual scale is an
   f32 mean/max whose summation order differs between frameworks, so it can
   differ in its last ulp and move a code by one step at a rounding edge).
2. State carried across (``from_state``; ``load_index`` of a directory the
   reference saved): byte-identical state, derived tables exact, search ids
   equal on >= 99% of slots and recall@10 within 0.01.
3. A save by the port loads in the reference.
4. ``tune`` picks an op point with ``met=True``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.index import load_index as jax_load_index
from cloudvectordb_tpu.index.ivf_band import BandIVFIndex as JaxBandIVFIndex
from cloudvectordb_tpu.utils import native as jax_native
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex
from cloudvectordb_tpu_torch.index.registry import load_index
from cloudvectordb_tpu_torch.utils import native

KW = dict(nlist=16, dtype="int8", residual=True, kmeans_iters=6, tile_n=256, tile_q=16)


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4000, 64, n_clusters=32, seed=90, normalize=True)
    q = queries_from(db, 48, seed=91, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    return db, q, gt


@pytest.fixture(scope="module")
def jidx(data):
    return JaxBandIVFIndex.build(data[0], **KW)


def _assert_same_tables(t, j):
    np.testing.assert_array_equal(t._offsets, j._offsets)
    np.testing.assert_array_equal(t._ids, np.asarray(j._ids))
    np.testing.assert_array_equal(t._tile_window, j._tile_window)
    np.testing.assert_array_equal(t._local, j._local)
    np.testing.assert_array_equal(t._valid_end, j._valid_end)
    np.testing.assert_array_equal(t._centroid_tiles, j._centroid_tiles)
    assert t._n == j._n and t.ntotal == j.ntotal


def _assert_same_arena(t, j, min_equal=0.9999):
    pj = np.asarray(j._payload).astype(np.int16)
    pt = t._payload.cpu().numpy().astype(np.int16)
    assert pj.shape == pt.shape
    diff = np.abs(pj - pt)
    assert diff.max() <= 1 and (diff == 0).mean() >= min_equal, (
        diff.max(), (diff == 0).mean())


def _assert_same_search(t, j, q, gt, p_tiles, tile_q=None):
    _, ij = j.search(q, 10, p_tiles=p_tiles, tile_q=tile_q)
    _, it = t.search(q, 10, p_tiles=p_tiles, tile_q=tile_q)
    assert (it == ij).mean() >= 0.99, (p_tiles, (it == ij).mean())
    if gt is not None:
        assert abs(recall_at_k(it, gt) - recall_at_k(ij, gt)) <= 0.01


def test_layout_parity_build(data, jidx):
    db, q, gt = data
    t = BandIVFIndex.build(db, centroids=jidx.centroids, device="cpu", **KW)
    _assert_same_tables(t, jidx)
    assert t._scale == pytest.approx(jidx._scale, rel=1e-6)
    _assert_same_arena(t, jidx)
    _assert_same_search(t, jidx, q, gt, t._tune_n_tiles())


def test_layout_parity_device_streaming(data):
    db, q, gt = data
    kw = dict(KW, train_sample=1000)
    j = JaxBandIVFIndex.build_device_streaming(
        lambda i: jnp.asarray(db[i * 1000:(i + 1) * 1000]), 4, **kw)
    t = BandIVFIndex.build_device_streaming(
        lambda i: torch.from_numpy(db[i * 1000:(i + 1) * 1000]), 4,
        centroids=j.centroids, device="cpu", **kw)
    _assert_same_tables(t, j)
    assert t._scale == pytest.approx(j._scale, rel=1e-6)
    _assert_same_arena(t, j)
    _assert_same_search(t, j, q, gt, 8)


def test_layout_parity_tile_span_cap_holes(data):
    """Hundreds of one- and two-row lists: the cap pads holes at tile
    boundaries, valid_end masks them, and both packages agree."""
    db, q, _ = data
    kw = dict(KW, nlist=400, kmeans_iters=3)
    j = JaxBandIVFIndex.build(db[:600], **kw)
    assert j._offsets[-1] > 600 and j._list_lens is not None  # holes were padded
    t = BandIVFIndex.build(db[:600], centroids=j.centroids, device="cpu", **kw)
    _assert_same_tables(t, j)
    np.testing.assert_array_equal(t._list_lens, j._list_lens)
    _assert_same_arena(t, j)
    assert 64 < t._tile_window.shape[1] <= 129  # wide windows, capped
    _assert_same_search(t, j, q, None, t._tune_n_tiles())


@pytest.mark.parametrize("route", ["from_state", "load_index"])
def test_state_carried_across(data, jidx, route, tmp_path):
    db, q, gt = data
    if route == "from_state":
        t = BandIVFIndex.from_state(jidx._state_meta(), jidx._state_arrays(), device="cpu")
    else:
        jidx.save(tmp_path / "jax_saved")
        t = load_index(tmp_path / "jax_saved", device="cpu")
    _assert_same_tables(t, jidx)
    _assert_same_arena(t, jidx, min_equal=1.0)
    assert t._scale == jidx._scale and t._gid_bound() == jidx._gid_bound()
    for p in (4, 8, t._tune_n_tiles()):
        _assert_same_search(t, jidx, q, gt, p)
    _assert_same_search(t, jidx, q, gt, 0)  # the auto budget
    _assert_same_search(t, jidx, q[:5], None, 0)  # small-batch tile_q shrink
    _assert_same_search(t, jidx, q, gt, 8, tile_q=32)


def test_port_save_loads_in_reference(data, jidx, tmp_path):
    db, q, gt = data
    t = BandIVFIndex.build(db, centroids=jidx.centroids, device="cpu", **KW)
    t._op_point = {"p_tiles": 8, "tile_q": 16}
    t.save(tmp_path / "port_saved")
    manifest = json.loads((tmp_path / "port_saved" / "manifest.json").read_text())
    assert manifest["kind"] == "band_ivf" and manifest["op_point"] == t._op_point
    j = jax_load_index(tmp_path / "port_saved")
    _assert_same_tables(t, j)
    _assert_same_arena(t, j, min_equal=1.0)
    assert j._op_point == t._op_point
    _assert_same_search(t, j, q, gt, 0)  # both serve the saved op point
    t2 = load_index(tmp_path / "port_saved", device="cpu")
    assert t2._op_point == t._op_point
    np.testing.assert_array_equal(t2.search(q, 10)[1], t.search(q, 10)[1])


def test_tune_picks_a_passing_op_point(data, jidx, tmp_path):
    db, q, gt = data
    t = BandIVFIndex.from_state(jidx._state_meta(), jidx._state_arrays(), device="cpu")
    report = t.tune(q, k=10, target_recall=0.95)
    assert report["met"], report
    assert 0 < report["op"]["p_tiles"] <= t._tune_n_tiles()
    assert t._op_point == report["op"] and report["qps"] > 0
    assert all("recall" in r or "skipped" in r for r in report["tried"])
    _, found = t.search(q, 10)  # no knobs: the op point serves
    assert recall_at_k(found, gt) >= 0.85
    t.save(tmp_path / "tuned")
    assert load_index(tmp_path / "tuned", device="cpu")._op_point == report["op"]


def test_search_device_matches_search(data, jidx):
    db, q, _ = data
    t = BandIVFIndex.from_state(jidx._state_meta(), jidx._state_arrays(), device="cpu")
    q45 = q[:45]  # not a tile_q multiple: padded by repeating the last query
    v_h, i_h = t.search(q45, 10, p_tiles=8)
    v_d, i_d = t.search_device(torch.from_numpy(q45), 10, p_tiles=8)
    assert i_d.dtype == torch.int32 and v_d.shape == (45, 10)
    np.testing.assert_array_equal(i_d.numpy(), i_h)
    np.testing.assert_array_equal(v_d.numpy(), v_h)


def test_unported_options_raise(data, jidx, tmp_path):
    with pytest.raises(NotImplementedError):
        BandIVFIndex(64, 16, residual=True, slack=0.5, device="cpu")
    with pytest.raises(NotImplementedError):
        BandIVFIndex(64, 16, residual=True, metric="l2", device="cpu")
    t = BandIVFIndex.from_state(jidx._state_meta(), jidx._state_arrays(), device="cpu")
    with pytest.raises(NotImplementedError):
        t.search(data[1], 10, top2=True)  # K1's top2 variant
    with pytest.raises(NotImplementedError):
        t.add(data[0][:4])
    with pytest.raises(NotImplementedError):
        t.search(data[1], 10, scoring="precise")
    (tmp_path / "pq").mkdir()
    (tmp_path / "pq" / "manifest.json").write_text(json.dumps(
        {"kind": "ivf_pq", "meta": {}, "arrays": []}))
    with pytest.raises(NotImplementedError):
        load_index(tmp_path / "pq", device="cpu")


def test_native_arena_sort_matches_reference_loader():
    a = np.random.default_rng(5).integers(0, 300, size=200_000).astype(np.int32)
    order, offsets = native.arena_sort(a, 300)
    order_j, offsets_j = jax_native.arena_sort(a, 300)
    np.testing.assert_array_equal(order, order_j)
    np.testing.assert_array_equal(offsets, offsets_j)
    np.testing.assert_array_equal(order, np.argsort(a, kind="stable"))
    rows = np.random.default_rng(6).integers(-127, 128, size=(1000, 24), dtype=np.int8)
    idx = order[:1000] % 1000
    np.testing.assert_array_equal(native.gather_rows(rows, idx), rows[idx])
