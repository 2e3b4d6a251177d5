"""BandIVFPQIndex past its segment cap, held to the reference's segmented
index (tests/unit/test_band_ivf.py:845-960), with ``seg_rows_cap`` patched
to two tiles on both classes (the reference's tests take four; at two the
segmented ids differ from the joined arena's at k 10 on this data, so the
parity shows the segments are kept).

The reference stores such an arena as segments and K5 keeps each
segment's candidate pools apart; the port keeps one joined arena and K5
dispatches a segment at a time over views of it (ops/pq.py). So on the
same quantizers and data:

1. a device-streamed build of 4,000 rows (eight segments) returns the same
   ids as the reference's segmented index at full coverage and at a partial
   p_tiles, filtered and with top-2 too, on ``search`` and
   ``search_device``: ids equal on >= 0.999 of slots, scores within 1e-5;
2. an add, its merge, a save and a load keep the arena segmented and the
   ids the reference's; the port loads the reference's artifact, saved
   joined, segmented;
3. an int8 refine index that grows past the cap: the reference refuses the
   merge (its rows would not fit a TPU's memory), the port merges and
   serves it, a difference by design (ROADMAP.md queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.index import load_index as jax_load_index
from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex as JaxPQ
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex
from cloudvectordb_tpu_torch.index.registry import load_index

#: the reference's segmented tests' settings; the cap is two tiles
KW = dict(nlist=16, m=8, nbits=5, kmeans_iters=5, pq_train_iters=5, tile_n=256, tile_q=16)
CAP = 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch here: the tiny CPU shapes gain nothing
    from more, and under several test workers on one machine the extra
    threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def capped(monkeypatch):
    monkeypatch.setattr(JaxPQ, "seg_rows_cap", CAP)
    monkeypatch.setattr(BandIVFPQIndex, "seg_rows_cap", CAP)


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4000, 64, n_clusters=32, seed=90, normalize=True)
    q = queries_from(db, 48, seed=91, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    return db, q, gt


def _quantizers(j) -> dict:
    return dict(centroids=j.centroids, codebooks=j.codebooks)


def _streamed_pair(chunks, **kw):
    """The reference's device-streamed build and the port's on its
    quantizers, from the same chunks."""
    kw = {**KW, "refine": "none", "train_sample": 2048, **kw}
    j = JaxPQ.build_device_streaming(lambda i: jnp.asarray(chunks[i]), len(chunks), **kw)
    t = BandIVFPQIndex.build_device_streaming(lambda i: chunks[i], len(chunks), device="cpu",
                                              **_quantizers(j), **kw)
    return j, t


def _assert_same(got, ref, gt):
    (vt, it), (vj, ij) = got, ref
    vt, it, vj, ij = (np.asarray(a) for a in (vt, it, vj, ij))
    assert it.shape == ij.shape and (it == ij).mean() >= 0.999, (it != ij).sum()
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-5)
    assert abs(recall_at_k(it, gt) - recall_at_k(ij, gt)) <= 0.005


def _segments_of(t) -> list:
    return [int(r) for r in t._seg_rows()]


def test_pq_segmented_arena_matches_the_reference(data, capped):
    """Eight segments on both sides, the same codes, and the reference's
    segmented ids at full coverage and at a partial p_tiles, at k 10 and
    40, with a filter, with top-2 and on the device route. The joined
    dispatch on the same arena returns other ids, and the segmented
    candidates only widen its (the reference's own rule)."""
    db, q, gt = data
    j, t = _streamed_pair([db[:2000], db[2000:]])
    assert j._segmented and t._segmented
    assert _segments_of(t) == [int(np.asarray(s).shape[0]) - t.tile_n for s in j._codes_cm]
    assert t._seg_n_valid() == tuple(int(v) for v in j._seg_n_valid())
    np.testing.assert_array_equal(t._codes.numpy(), j._codes_np_rows())
    nt = t._tune_n_tiles()
    allow = np.random.default_rng(5).random(db.shape[0]) < 0.3
    for k, kw in ((10, dict(p_tiles=nt)), (10, dict(p_tiles=5)), (40, dict(p_tiles=nt)),
                  (10, dict(p_tiles=nt, top2=True)), (10, dict(p_tiles=6, where=allow))):
        _assert_same(t.search(q, k, **kw), j.search(q, k, interpret=True, **kw), gt)
    _assert_same(t.search_device(torch.from_numpy(q), 10, p_tiles=7),
                 j.search_device(jnp.asarray(q), 10, p_tiles=7, interpret=True), gt)
    _, f_seg = t.search(q, 10, p_tiles=nt)
    t.seg_rows_cap = t._n_pad_rows  # the joined dispatch on the same arena
    assert t._seg_rows() is None
    _, f_joined = t.search(q, 10, p_tiles=nt)
    assert (f_seg != f_joined).any()
    assert recall_at_k(f_seg, gt) >= recall_at_k(f_joined, gt) - 1e-9


def test_pq_segmented_add_merge_save_load(data, capped, tmp_path):
    """An add on a segmented index, its merge (re-segmented from the new
    row count), save (one joined matrix) and load (segmented again): the
    reference's ids at each step; the port loads the reference's artifact
    segmented too."""
    db, q, gt = data
    j, t = _streamed_pair([db[:1500], db[1500:3000]])
    assert j._segmented and t._segmented
    for idx in (j, t):
        idx.add(db[3000:])
        idx.merge_pending()
        assert idx._pending.size == 0 and idx.ntotal == db.shape[0] and idx._segmented
    assert _segments_of(t) == [CAP] * 8
    nt = t._tune_n_tiles()
    ref = j.search(q, 10, p_tiles=nt, interpret=True)
    got = t.search(q, 10, p_tiles=nt)
    _assert_same(got, ref, gt)
    np.testing.assert_allclose(t.reconstruct(np.arange(3000, 3032)),
                               j.reconstruct(np.arange(3000, 3032)), atol=1e-5)
    t.save(tmp_path / "port")
    j.save(tmp_path / "ref")
    for path in ("port", "ref"):
        loaded = load_index(tmp_path / path, device="cpu")
        assert loaded._segmented and _segments_of(loaded) == [CAP] * 8
        np.testing.assert_array_equal(loaded.search(q, 10, p_tiles=nt)[1], got[1])
    assert jax_load_index(tmp_path / "port")._segmented  # and the reference loads the port's


def test_segmented_refine_growth_the_reference_raises_the_port_serves(data, capped):
    """An int8 refine index crossing the cap at a merge: the reference
    raises NotImplementedError (refined indexes are bounded to one segment
    by a TPU's memory); the port merges and serves it through the segmented
    dispatch, its recall with the int8 rescore near the joined dispatch's
    on the same arena and the refine route's."""
    db, q, gt = data
    j = JaxPQ.build(db[:1000], nlist=8, m=8, nbits=5, refine="int8", kmeans_iters=4,
                    pq_train_iters=4, tile_n=256, tile_q=16)
    j.merge_threshold = 1e9
    j.add(db[1000:])
    with pytest.raises(NotImplementedError):
        j.merge_pending()
    t = BandIVFPQIndex.build(db[:1000], nlist=8, m=8, nbits=5, refine="int8", kmeans_iters=4,
                             pq_train_iters=4, tile_n=256, tile_q=16, device="cpu",
                             **_quantizers(j))
    t.merge_threshold = 1e9
    t.add(db[1000:])
    t.merge_pending()
    assert t._segmented and t.ntotal == db.shape[0]
    nt = t._tune_n_tiles()
    _, f_seg = t.search(q, 10, p_tiles=nt, serve_from="pq", refine_factor=16)
    _, f_dev = t.search_device(torch.from_numpy(q), 10, p_tiles=nt, serve_from="pq",
                               refine_factor=16)
    np.testing.assert_array_equal(f_dev.numpy(), f_seg)
    _, f_scan = t.search(q, 10, p_tiles=nt, serve_from="refine")
    t.seg_rows_cap = t._n_pad_rows
    _, f_joined = t.search(q, 10, p_tiles=nt, serve_from="pq", refine_factor=16)
    r_seg = recall_at_k(f_seg, gt)
    assert r_seg >= recall_at_k(f_joined, gt) - 0.02, (r_seg, recall_at_k(f_joined, gt))
    assert r_seg >= recall_at_k(f_scan, gt) - 0.05 and r_seg >= 0.8, r_seg
