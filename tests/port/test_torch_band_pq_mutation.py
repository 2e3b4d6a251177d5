"""Mutation of the BandIVFPQIndex (add and the pending buffer, merge_pending,
remove, reconstruct, merge_from, build_streaming), the port held to the
reference on the same inputs and quantizers.

After each state the arena and the gid-keyed tier stores are the
reference's byte for byte (``test_torch_band_pq_index._assert_same_arena``
and ``_assert_same_tiers``: the codes, local bytes, ids, offsets and
tier-2 codes exactly; int8 rows, pending rows and host rows equal on >=
99.99% of bytes with |Δ| <= 1, their scales f32 means and maxima summed in
another order), and searches return the same ids on >= 0.999 of slots,
scores within 1e-5 (``_assert_same_search``). Models:
tests/unit/test_remove.py:248-300, test_merge_from.py:100-190 and
test_band_ivf.py:176-230.
"""

import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex as JaxPQ
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex
from test_torch_band_pq_index import (
    KW, _assert_same_arena, _assert_same_search, _assert_same_tiers, _same_quantizers)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch here: the tiny CPU shapes gain nothing
    from more, and under several test workers on one machine the extra
    threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


#: the refine tiers mutated: build kwargs
TIERS = {"resid_int8": dict(refine="int8"), "whole_int8": dict(refine="int8", residual=False),
         "none_opq": dict(refine="none", opq=True), "pq2_l2": dict(refine="pq2", m2=16,
                                                                   metric="l2"),
         "host": dict(refine="host")}


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4000, 64, n_clusters=32, seed=110, normalize=True)
    q = queries_from(db, 24, seed=111, normalize=True)
    return db, q


def _gt(rows, gids, q):
    _, pos = brute_force_topk(rows, q, 10, metric="ip")
    return gids[pos]


def _pair(rows, **kw):
    j = JaxPQ.build(rows, **{**KW, **kw})
    return j, BandIVFPQIndex.build(rows, device="cpu", **dict(KW, **_same_quantizers(j)))


def _assert_same_pending(t, j):
    """The pending buffers: ids, lists and codes exactly, int8 rows within
    one step (their scale, like the arena's, an f32 mean/max)."""
    assert t._pending.size == j._pending.size
    if not t._pending.size:
        return
    rt, it, at = t._pending.snapshot_full()
    rj, ij, aj = j._pending.snapshot_full()
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_array_equal(np.concatenate(t._pending_codes),
                                  np.concatenate(j._pending_codes))
    assert np.abs(rt.astype(np.int16) - rj.astype(np.int16)).max() <= 1
    assert t._pending_scale == pytest.approx(j._pending_scale, rel=1e-6)


@pytest.mark.parametrize("name", list(TIERS))
def test_add_pending_merge_and_remove_match_the_reference(data, name):
    """Build on 3000 rows, add 600 (pending: below the merge threshold),
    search with them pending, merge, remove every 7th id (arena and pending
    rows), search again: each state the reference's."""
    db, q = data
    j, t = _pair(db[:3000], **TIERS[name])
    for idx in (j, t):
        idx.add(db[3000:3400])
        idx.add(db[3400:3600])
    _assert_same_pending(t, j)
    _assert_same_tiers(t, j)
    gt = _gt(db[:3600], np.arange(3600), q)
    kw = dict(p_tiles=6, refine_factor=16)
    _assert_same_search(t, j, q, gt, **kw)
    if not (t._have_host() and not t._have_tier2()):
        _assert_same_search(t, j, q, gt, device=True, **kw)
    for idx in (j, t):
        idx.merge_pending()
    assert t._pending.size == 0 and t._n == 3600
    _assert_same_arena(t, j)
    _assert_same_tiers(t, j)
    _assert_same_search(t, j, q, gt, **kw)
    for idx in (j, t):
        idx.add(db[3600:3700])  # pending again, and some of it removed
    removed = np.arange(0, 3700, 7)
    assert t.remove(removed) == j.remove(removed) == removed.size
    _assert_same_arena(t, j)
    _assert_same_pending(t, j)
    keep = np.setdiff1d(np.arange(3700), removed)
    gt = _gt(db[keep], keep, q)
    _assert_same_search(t, j, q, gt, **kw)
    _, found = t.search(q, 10, p_tiles=t._tune_n_tiles(), refine_factor=32)
    assert not np.isin(found, removed).any()


def test_self_hits_and_reconstruct(data):
    """Added rows find themselves while pending and once merged (the
    reference's r1 regression); reconstruct matches the reference's for
    arena rows (refine rows, host rows, the PQ decode) and pending rows,
    in the original space (OPQ undone)."""
    db, q = data
    for kw in (dict(refine="int8", opq=True), dict(refine="host"), dict(refine="none")):
        j, t = _pair(db[:3200], **kw)
        for idx in (j, t):
            idx.add(db[3200:3400])
        ids = np.r_[0:40, 3200:3240]
        np.testing.assert_allclose(t.reconstruct(ids), j.reconstruct(ids), atol=2e-5)
        _, found = t.search(db[3200:3232], 1, p_tiles=t._tune_n_tiles())
        assert (found[:, 0] == 3200 + np.arange(32)).mean() >= 0.9
        for idx in (j, t):
            idx.merge_pending()
        np.testing.assert_allclose(t.reconstruct(ids), j.reconstruct(ids), atol=2e-5)
        with pytest.raises(ValueError):
            t.reconstruct([5000])


@pytest.mark.parametrize("tier", [dict(refine="int8"), dict(refine="pq2", m2=8, nbits2=6,
                                                              metric="l2"),
                                  dict(refine="host")])
def test_merge_from_matches_the_reference(data, tier):
    """Two indexes over disjoint halves sharing one quantizer set (the
    second's scales its own), merged with an id offset: the arena and the
    tier stores the reference's, the second's tier rows under their
    shifted ids, and the merged index's recall within 0.03 of one build
    over the union."""
    db, q = data
    kw_full = dict(KW, seed=7, **tier)
    ja = JaxPQ.build(db[:2048], **kw_full)
    jb = JaxPQ(64, 16, **{k: v for k, v in kw_full.items() if k != "nlist"})
    jb.centroids, jb.codebooks, jb.codebooks2 = ja.centroids, ja.codebooks, ja.codebooks2
    jb._populate(db[2048:3072])
    ta = BandIVFPQIndex.build(db[:2048], device="cpu", **dict(kw_full, **_same_quantizers(ja)))
    tb = BandIVFPQIndex(64, 16, device="cpu", **{k: v for k, v in kw_full.items()
                                                 if k != "nlist"})
    tb.centroids, tb.codebooks, tb.codebooks2 = ja.centroids, ja.codebooks, ja.codebooks2
    tb._populate(torch.from_numpy(db[2048:3072]))
    if tier["refine"] == "host":
        assert ta._host_scale != tb._host_scale  # the scale-unifying path
    assert ta.merge_from(tb, id_offset=2048) == ja.merge_from(jb, id_offset=2048) == 1024
    _assert_same_arena(ta, ja)
    _assert_same_tiers(ta, ja)
    if ta._tier2_active:
        np.testing.assert_array_equal(ta._codes2_device().numpy()[2048:3072],
                                      tb._codes2_device().numpy())
    with pytest.raises(ValueError):  # the same ids again
        ta.merge_from(tb)
    gt = _gt(db[:3072], np.arange(3072), q)
    kw = dict(p_tiles=ta._tune_n_tiles(), refine_factor=16)
    _assert_same_search(ta, ja, q, gt, **kw)
    u = BandIVFPQIndex.build(db[:3072], device="cpu", **dict(kw_full, **_same_quantizers(ja)))
    r_merged = recall_at_k(ta.search(q, 10, **kw)[1], gt)
    # the reference's own test's bound (test_merge_from.py:131-136): 24
    # queries, so one slot is 0.004
    assert abs(r_merged - recall_at_k(u.search(q, 10, **kw)[1], gt)) <= 0.03


@pytest.mark.parametrize("tier", [dict(refine="int8", opq=True),
                                  dict(refine="pq2", m2=16, metric="l2"),
                                  dict(refine="host", aniso_eta=4.0)])
def test_build_streaming_matches_the_reference(data, tier):
    """The host-assembled build from chunks: the arena, refine rows and
    tier stores (pending appends, folded) the reference's, and the same
    codes as ``build_device_streaming`` given the same quantizers."""
    db, q = data
    chunks = [db[i:i + 1000] for i in range(0, 4000, 1000)]
    j = JaxPQ.build_streaming(iter(chunks), train_sample=1000, **{**KW, **tier})
    t = BandIVFPQIndex.build_streaming(iter(chunks), train_sample=1000, device="cpu",
                                       **dict(KW, **_same_quantizers(j)))
    _assert_same_arena(t, j)
    _assert_same_tiers(t, j)
    gt = _gt(db, np.arange(4000), q)
    _assert_same_search(t, j, q, gt, p_tiles=6, refine_factor=16)
    d = BandIVFPQIndex.build_device_streaming(
        lambda i: torch.from_numpy(chunks[i]), 4, train_sample=1000, device="cpu",
        **dict(KW, **_same_quantizers(j)))
    assert torch.equal(d._codes, t._codes) and torch.equal(d._local, t._local)
    if t._tier2_active:
        assert torch.equal(d._codes2_device(), t._codes2_device())
