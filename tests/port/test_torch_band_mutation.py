"""Mutation of the BandIVFIndex (slack arenas, add, remove, the pending
buffer and the device annex, the in-place merge, merge_from, reconstruct,
build_streaming), the port held to the reference on the same inputs.

Each test feeds the same numpy rows to both packages, the port built from
the reference's centroids (the reference's jax.random k-means cannot be
reproduced in torch), and the reference indexes built rather than loaded,
so that both keep a device arena and fold into the annex alike. Every
build trains on 3000 rows, so the reference compiles k-means once. After each
step:
- layout tables exact: offsets, ids, list_lens, valid_end, local ids, the
  tile window, extent, ntotal, pending and annex counts;
- the int8 payload equal on >= 99.99% of bytes with |Δ| <= 1 (the scale is
  an f32 mean/max whose summation order differs between the frameworks);
- searches (the reference's Pallas kernels in interpret mode) with scores
  within 1e-4 (l2 keys 2e-4), ids equal on >= 99% of slots, every
  differing id a near-tie, unfilled slots (-inf, -1) in both.

The filter is applied to pending and annex rows before their top-k in the
port; the reference applies it after and can lose allowed rows
(``test_filtered_pending_keeps_allowed_rows``). Elsewhere the filters are
ones on which the two agree.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.index import arena as jax_arena
from cloudvectordb_tpu.index import load_index as jax_load_index
from cloudvectordb_tpu.index.ivf_band import BandIVFIndex as J
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.index import arena, ivf_band
from cloudvectordb_tpu_torch.index.filters import IdFilter
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex as T
from cloudvectordb_tpu_torch.index.ivf_band import _arena_mask_from_ids
from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex
from cloudvectordb_tpu_torch.index.registry import load_index
from cloudvectordb_tpu_torch.ops.band import resid_row_bias

RKW = dict(nlist=16, dtype="int8", residual=True, kmeans_iters=6, tile_n=256, tile_q=16)
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4000, 64, n_clusters=32, seed=70, normalize=True)
    q = queries_from(db, 16, seed=71, normalize=True)
    return db, q


def _pair(rows, **kw):
    """(reference build, port build from its centroids)."""
    j = J.build(rows, **kw)
    return j, T.build(rows, centroids=j.centroids, **CPU, **kw)


@pytest.fixture(scope="module")
def built(data):
    """pair(**kw): a copy of (reference build, port build) over the first
    3000 rows (one row count: the reference compiles k-means once)."""
    cache = {}

    def pair(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            cache[key] = _pair(data[0][:3000], **kw)
        return copy.deepcopy(cache[key])

    return pair


def _pair_streaming(db, **kw):
    """(reference, port) device-streaming builds over the first 3000 rows,
    in one chunk."""
    j = J.build_device_streaming(lambda i: jnp.asarray(db[:3000]), 1, **kw)
    t = T.build_device_streaming(lambda i: torch.from_numpy(db[:3000]), 1,
                                 centroids=j.centroids, **CPU, **kw)
    return j, t


def _same_state(t, j, min_equal=0.9999):
    np.testing.assert_array_equal(t._offsets, j._offsets)
    np.testing.assert_array_equal(t._ids, np.asarray(j._ids))
    np.testing.assert_array_equal(t._tile_window, j._tile_window)
    assert (t._list_lens is None) == (j._list_lens is None)
    if t._list_lens is not None:
        np.testing.assert_array_equal(t._list_lens, j._list_lens)
    if t.residual:
        np.testing.assert_array_equal(t._local, j._local)
        np.testing.assert_array_equal(t._valid_end, j._valid_end)
    assert (t._n, t.ntotal, t._pending.size) == (j._n, j.ntotal, j._pending.size)
    assert (t._annex or {}).get("n", 0) == (j._annex or {}).get("n", 0)
    if t._annex is not None and t._annex["n"]:
        n = t._annex["n"]
        np.testing.assert_array_equal(t._annex["ids"][:n], j._annex["ids"][:n])
        np.testing.assert_array_equal(t._annex["assign"][:n].numpy(),
                                      np.asarray(j._annex["assign"][:n]))
        _same_bytes(t._annex["rows"][:n], j._annex["rows"][:n], min_equal)
    pj, pt = np.asarray(j._payload), t._payload
    if t.dtype == "int8":
        _same_bytes(pt, pj, min_equal)
    else:
        np.testing.assert_array_equal(pt.float().numpy(),
                                      np.asarray(jnp.asarray(pj).astype(jnp.float32)))


def _same_bytes(t_rows, j_rows, min_equal):
    pj = np.asarray(j_rows).astype(np.int16)
    pt = t_rows.numpy().astype(np.int16)
    assert pj.shape == pt.shape
    diff = np.abs(pj - pt)
    assert diff.max(initial=0) <= 1 and (diff == 0).mean() >= min_equal, (
        diff.max(), (diff == 0).mean())


def _same_scored(t, j, q, k=10, **kw):
    """Scores within 1e-4 (l2 keys 2e-4), ids equal on >= 99% of slots,
    each differing id a near-tie, unfilled slots (-inf, -1) in both."""
    tol = 2e-4 if t.metric == "l2" else 1e-4
    vj, ij = j.search(q, k, **kw)
    vt, it = t.search(q, k, **kw)
    vj, ij = np.asarray(vj), np.asarray(ij).astype(np.int64)
    live = np.isfinite(vj)
    np.testing.assert_array_equal(np.isfinite(vt), live)
    np.testing.assert_array_equal(it[~live], ij[~live])
    np.testing.assert_allclose(vt[live], vj[live], atol=tol, rtol=0)
    same = it == ij
    assert same.mean() >= 0.99, same.mean()
    assert np.all(np.abs(vt - vj)[~same & live] <= tol)
    return vt, it


def _p_all(idx):
    return int(idx._payload.shape[0]) // idx.tile_n


def _surviving_gt(rows, ids, q, removed, k=10):
    keep = ~np.isin(ids, removed)
    _, pos = brute_force_topk(rows[keep], q, k, metric="ip")
    return ids[keep][pos]


# -- the pending buffer ------------------------------------------------------
def test_pending_buffer_matches_reference():
    """Model: tests/unit/test_arena.py:47-60, and PendingBuffer.remove_ids."""
    rng = np.random.default_rng(3)
    t, j = arena.PendingBuffer(3, np.int8), jax_arena.PendingBuffer(3, np.int8)
    assert t.snapshot() is None and t.size == 0
    for lo, n in ((0, 4), (4, 5), (9, 3)):
        rows = rng.integers(-127, 128, (n, 3))
        for b in (t, j):
            b.append(rows, np.arange(lo, lo + n), rng.integers(0, 4, n) * 0 + lo % 4)
    assert t.size == j.size == 12
    for a, b in zip(t.snapshot_full(), j.snapshot_full()):
        np.testing.assert_array_equal(a, b)
    assert t.size == 12  # a snapshot does not clear
    n_t, m_t = t.remove_ids(np.array([1, 2, 9, 10, 11]))
    n_j, m_j = j.remove_ids(np.array([1, 2, 9, 10, 11]))
    assert n_t == n_j == 5 and len(m_t) == len(m_j) == 3
    for a, b in zip(m_t, m_j):
        np.testing.assert_array_equal(a, b)
    assert len(t._chunks) == 2  # the emptied chunk is dropped
    for a, b in zip(t.drain(), j.drain()):
        np.testing.assert_array_equal(a, b)
    p, i, a = t.drain()
    assert t.size == 0 and p.shape == (0, 3) and i.shape == (0,) and a.shape == (0,)


# -- add, the pending buffer, the annex, merges ---------------------------------
def test_whole_row_add_pending_then_merge(data, built):
    """Model: test_band_ivf.py:139 (int8 whole rows: adds stay pending, then
    a forced merge); ids from the allocator; the tiles and band strategies
    merge the pending rows."""
    db, q = data
    j, t = built(**dict(RKW, residual=False))
    for s in range(3000, 4000, 250):
        j.add(db[s:s + 250])
        t.add(db[s:s + 250])
        _same_state(t, j)
    assert t._pending.size == 1000 and t._gid_bound() == 4000
    _same_scored(t, j, db[3000:3016], p_tiles=8)
    _same_scored(t, j, q, strategy="band")  # K7's result merged with pending rows
    j.merge_pending()
    t.merge_pending()
    _same_state(t, j)


def test_residual_add_reconstruct_merge_save_load(data, built, tmp_path):
    """Model: test_band_ivf.py:263: residual adds stay pending (below the
    fold floor of 4 tiles), reconstruct covers arena and pending rows, the
    merged arena saves in one package and loads in the other."""
    db, q = data
    j, t = built(**RKW)
    for s in range(3000, 4000, 500):
        j.add(db[s:s + 500])
        t.add(db[s:s + 500])
    _same_state(t, j)
    _same_scored(t, j, db[3500:3516], k=1, p_tiles=8)
    ids = np.r_[0:40, 3480:3520]
    np.testing.assert_allclose(t.reconstruct(ids), j.reconstruct(ids), atol=1e-6, rtol=0)
    rec = t.reconstruct(np.arange(64))
    cos = (rec * db[:64]).sum(1) / np.linalg.norm(rec, axis=1)
    assert cos.min() > 0.99
    with pytest.raises(ValueError):
        t.reconstruct([4000])
    t.save(tmp_path / "port")  # merges first, as the reference's save
    assert t._pending.size == 0 and t.ntotal == 4000
    j.save(tmp_path / "ref")
    jt = jax_load_index(tmp_path / "port")
    tj = load_index(tmp_path / "ref", **CPU)
    _same_state(t, jt)
    _same_state(tj, j, min_equal=1.0)
    _same_scored(tj, jt, q, p_tiles=8)


def test_device_annex_fold_and_search_device(data):
    """Model: test_band_ivf.py:308 and :1154: on a device-streaming arena
    (tile_n 128: a fold floor of 512 rows) adds past the threshold fold into
    the annex, the arena buffer untouched, the remainder stays pending;
    search and search_device agree over arena, annex and pending rows; the
    annex keeps its rows through a remove and a merge."""
    db, q = data
    kw = dict(RKW, tile_n=128)
    j, t = _pair_streaming(db, **kw)
    ptr = t._payload.data_ptr()
    for s in range(3000, 4000, 250):
        j.add(db[s:s + 250])
        t.add(db[s:s + 250])
        _same_state(t, j)
    assert t._annex["n"] == 750 and t._pending.size == 250
    assert t._payload.data_ptr() == ptr and t.ntotal == 4000
    vt, it = _same_scored(t, j, q, p_tiles=8)
    vd, idd = t.search_device(torch.from_numpy(q), 10, p_tiles=8)
    assert idd.dtype == torch.int32
    np.testing.assert_array_equal(idd.numpy(), it)
    np.testing.assert_array_equal(vd.numpy(), vt)
    _, self_hit = t.search(db[3000:3016], 1, p_tiles=8)
    assert (self_hit[:, 0] == np.arange(3000, 3016)).all()
    removed = np.r_[3100:3110, 3900:3910, 0:10]  # annex, pending and arena rows
    assert j.remove(removed) == t.remove(removed) == 30
    _same_state(t, j)
    _, found = t.search(q, 10, p_tiles=8)
    assert not np.isin(found, removed).any()
    j.merge_pending()
    t.merge_pending()
    _same_state(t, j)


@pytest.mark.parametrize("chunk", [ivf_band.MERGE_CHUNK, 64])
def test_inplace_merge_matches_reference(data, chunk):
    """Model: test_band_ivf.py:658-764: a compact arena built with headroom
    merges pending rows in place (the buffer and its capacity kept), to the
    reference's layout and bytes; the next merges, until the headroom is
    spent, and then the host merge. With ``chunk`` 64 every list shifts by
    more than a block, over some 40 blocks moved from the top down, each
    copied out before it is written: a block written before it is read, or
    blocks moved upward, would corrupt rows the reference keeps."""
    db, q = data
    kw = dict(RKW, merge_headroom=0.35)
    j, t = _pair_streaming(db, **kw)
    ptr, cap = t._payload.data_ptr(), int(t._payload.shape[0])
    for s in range(3000, 4000, 500):
        for idx in (j, t):
            idx.add(db[s:s + 500])
        j.merge_pending()
        t.merge_pending(chunk=chunk)
        _same_state(t, j)
    assert t._payload.data_ptr() == ptr and int(t._payload.shape[0]) == cap
    assert np.all(np.diff(t._offsets) > 0) and t._offsets[1] > 0
    _same_scored(t, j, q, p_tiles=8)
    for idx in (j, t):  # past the headroom: the host merge re-sizes the arena
        idx.add(db[:500])
        idx.merge_pending()
    _same_state(t, j)
    assert int(t._payload.shape[0]) > cap and t.ntotal == 4500


def test_move_rows_reads_each_block_before_writing_it():
    """``_move_rows`` with a shift smaller than the block: the block's own
    destinations overlap its sources."""
    buf = torch.arange(40, dtype=torch.int8).reshape(20, 2)
    want = buf.clone()
    dst = torch.arange(20) + 3
    ivf_band._move_rows(buf, dst, 0, 10)
    assert torch.equal(buf[3:13], want[0:10]) and torch.equal(buf[:3], want[:3])


# -- slack arenas ------------------------------------------------------------
def test_slack_build_add_spill_and_masking(data, built):
    """Model: test_band_ivf.py:552-640: slack changes the layout only (the
    compact build's scores at full coverage), adds land in place (no
    pending rows, the buffer kept), rows beyond a list's slack spill to
    pending, and merge_pending re-opens slack."""
    db, q = data
    j, t = built(slack=0.3, **RKW)
    _same_state(t, j)
    assert t._n > 3000 and t.ntotal == 3000
    _, compact = built(**RKW)
    vc, _ = compact.search(q, 10, p_tiles=_p_all(compact))
    vs, _ = t.search(q, 10, p_tiles=_p_all(t))
    np.testing.assert_allclose(vs, vc, atol=1e-6)
    ptr, extent = t._payload.data_ptr(), t._n
    for idx in (j, t):
        idx.add(db[3000:3400])
    _same_state(t, j)
    assert t._pending.size == 0 and t._n == extent and t._payload.data_ptr() == ptr
    for idx in (j, t):
        idx.merge_threshold = 1e9  # keep the spill pending
        idx.add(db[:3000])  # the same rows again, under new ids
    _same_state(t, j)
    assert t._pending.size > 0 and t.ntotal == 6400 and t._payload.data_ptr() == ptr
    _same_scored(t, j, db[3000:3016], p_tiles=8)
    j.merge_pending()
    t.merge_pending()
    _same_state(t, j)
    assert t._pending.size == 0 and t._list_lens.sum() == 6400


def test_slack_holes_never_surface():
    """Model: test_band_ivf.py:650: every row anti-correlated with the
    query; an unmasked hole (zero residual: the list centroid) would win."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(1, 64)).astype(np.float32)
    base /= np.linalg.norm(base)
    db = -base + 0.05 * rng.normal(size=(512, 64)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    c = db[rng.choice(512, 4, replace=False)]
    t = T.build(db, nlist=4, centroids=c, dtype="int8", tile_n=128, tile_q=8, residual=True,
                slack=0.5, **CPU)
    assert t._n > 512
    v, f = t.search(base, 10, p_tiles=_p_all(t))
    assert f.min() >= 0 and f.max() < 512 and (v < 0).all()


def test_slack_artifacts_load_both_ways(data, built, tmp_path):
    """Model: test_band_ivf.py:656-700: a slack arena with in-place adds and
    removes (list_lens on disk) saved by the reference loads in the port,
    whose in-place add then works on the loaded (read-only mapped) tables;
    the port's save loads in the reference."""
    db, q = data
    j, t = built(slack=0.3, **RKW)
    for idx in (j, t):
        idx.add(db[3000:3200])
        idx.remove(np.arange(0, 3000, 10))
    j.save(tmp_path / "ref")
    t.save(tmp_path / "port")
    tj = load_index(tmp_path / "ref", **CPU)
    jt = jax_load_index(tmp_path / "port")
    assert tj.slack == 0.3 and tj._list_lens is not None and tj._gid_bound() == 3200
    _same_state(tj, j, min_equal=1.0)
    _same_state(t, jt, min_equal=1.0)
    for idx in (tj, j):
        idx.add(db[3200:3300])
    _same_state(tj, j, min_equal=1.0)
    assert tj._pending.size == 0
    _same_scored(tj, j, q, p_tiles=8)


# -- remove ------------------------------------------------------------------
def test_slack_remove_in_place_then_refill(data, built):
    """Model: test_remove.py:141-180: with the device tables staged, a
    slack arena swap-removes in place (offsets, extent and buffer kept,
    valid_end retreats, the freed slots keep their bytes); removed ids never
    return; adds refill the freed slots in place under new ids."""
    db, q = data
    j, t = built(slack=0.1, **RKW)
    t._device_state()
    j._device_state()
    offsets, ptr = t._offsets, t._payload.data_ptr()
    before = t._payload.clone()
    removed = np.arange(0, 3000, 6)
    assert j.remove(removed) == t.remove(removed) == removed.size
    _same_state(t, j)
    assert t._offsets is offsets and t._payload.data_ptr() == ptr
    freed = np.flatnonzero(np.asarray(t._ids) < 0)
    assert torch.equal(t._payload[freed], before[freed])  # bytes kept, masked
    assert torch.equal(t._dev["valid_end"], torch.as_tensor(t._valid_end))
    np.testing.assert_array_equal(t._dev["ids"].numpy(), t._ids.astype(np.int32))
    _, found = _same_scored(t, j, q, p_tiles=8)
    assert not np.isin(found, removed).any()
    _, found = t.search(q, 10, p_tiles=_p_all(t))
    gt = _surviving_gt(db[:3000], np.arange(3000), q, removed)
    assert not np.isin(found, removed).any() and recall_at_k(found, gt) >= 0.85
    assert t.remove(removed[:5]) == 0 and t.remove([10 ** 9]) == 0
    for idx in (j, t):
        idx.add(db[removed[:400]])
    _same_state(t, j)
    assert t._pending.size == 0 and t._payload.data_ptr() == ptr and t.ntotal == 2900
    _, found = t.search(db[removed[:16]], 1, p_tiles=_p_all(t))
    assert (found >= 3000).all()


def test_compact_residual_remove_in_place_then_merge(data, built):
    """Model: test_remove.py:183-200 and :318-345: a compact residual arena
    removes in place (its list_lens materialize, valid_end falls below the
    capacity offsets); a later merge re-assembles a compact arena and drops
    the stale lens."""
    db, q = data
    j, t = built(**RKW)
    removed = np.arange(0, 3000, 13)
    assert j.remove(removed) == t.remove(removed) == removed.size
    _same_state(t, j)
    assert t._list_lens is not None
    _, found = _same_scored(t, j, q, p_tiles=8)
    assert not np.isin(found, removed).any()
    for idx in (j, t):
        idx.add(db[3000:4000])
        idx.merge_pending()
    _same_state(t, j)
    assert t._list_lens is None and t._n == t.ntotal == 4000 - removed.size


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_whole_row_remove_compacts(data, built, dtype):
    """Model: test_remove.py:241-252: whole-row arenas compact on remove
    (f32: its pending rows merged by the fold; int8: with annex rows)."""
    db, q = data
    j, t = built(**dict(RKW, residual=False, dtype=dtype, tile_n=128))
    for idx in (j, t):
        idx.add(db[3000:4000])
    removed = np.r_[0:4000:8]
    assert j.remove(removed) == t.remove(removed) == 500
    _same_state(t, j)
    assert t.ntotal == 3500 and (t._annex is not None) == (dtype == "int8")
    _, found = _same_scored(t, j, q, p_tiles=8)
    assert not np.isin(found, removed).any()


# -- merge_from, build_streaming, layouts ---------------------------------------
def test_merge_from_matches_reference(data, built):
    """Model: test_merge_from.py:35-65: two parts under one quantizer (the
    second's scale differs, so its rows requantize), merged to the
    reference's arena; colliding ids and a foreign quantizer are refused;
    later adds allocate past both id ranges."""
    db, q = data
    ja, ta = built(**RKW)
    jb = J(64, 16, **{k: v for k, v in RKW.items() if k != "nlist"})
    jb.centroids = ja.centroids
    jb._populate(db[3000:])
    tb = T.build(db[3000:], centroids=ja.centroids, **CPU, **RKW)
    assert ta._scale != tb._scale
    with pytest.raises(ValueError, match="colliding global ids"):
        ta.merge_from(tb)
    assert ja.merge_from(jb, id_offset=3000) == ta.merge_from(tb, id_offset=3000) == 1000
    _same_state(ta, ja)
    _same_scored(ta, ja, q, p_tiles=8)
    ta.add(db[:8])
    assert ta._gid_bound() == 4008
    other = T.build(db[:512], **CPU, **dict(RKW, seed=11))
    with pytest.raises(ValueError, match="quantizer"):
        ta.merge_from(other)


@pytest.mark.parametrize("residual", [False, True])
def test_build_streaming_matches_reference(data, residual):
    """Model: tests/integration/test_band_streaming.py:10: chunks assigned
    and quantized as they come, the arena assembled once; with the
    reference's centroids both packages lay out the same arena."""
    db, q = data
    kw = dict(RKW, residual=residual)
    j = J.build_streaming(iter([db[:3000], db[3000:]]), **kw)
    t = T.build_streaming(iter([db[:3000], db[3000:]]), centroids=j.centroids, **CPU, **kw)
    assert t.ntotal == 4000 and t._scale == pytest.approx(j._scale, rel=1e-6)
    _same_state(t, j)
    _same_scored(t, j, q, p_tiles=8)


def test_capped_assembly_holes():
    """Model: test_skew_layout.py:49: 1500 one-row lists force the
    tile-span cap through ``_assemble_compact``: the same holes, ids and
    windows as the reference; the planted rows retrievable."""
    rng = np.random.default_rng(3)
    n_single, heavy = 1500, 20
    nlist = n_single + heavy
    c = rng.standard_normal((nlist, 64)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    assigns = np.r_[np.arange(n_single), np.repeat(n_single + np.arange(heavy), 500)]
    resid = 0.01 * rng.standard_normal((assigns.size, 64)).astype(np.float32)
    scale = float(np.abs(resid).max() / 127.0)
    q8 = np.clip(np.round(resid / scale), -127, 127).astype(np.int8)
    out = []
    for cls, kw in ((J, {}), (T, CPU)):
        idx = cls(64, nlist=nlist, dtype="int8", residual=True, tile_n=256, tile_q=8, **kw)
        idx.centroids, idx._scale = c, scale
        idx._assemble_compact(q8 if cls is J else torch.from_numpy(q8),
                              np.arange(assigns.size), assigns.astype(np.int32))
        out.append(idx)
    j, t = out
    _same_state(t, j, min_equal=1.0)
    assert t._n > assigns.size and t._tile_window.shape[1] <= 129
    _, found = t.search(c[:64], 1, p_tiles=_p_all(t))
    assert (found[:, 0] == np.arange(64)).all()


# -- filters, l2 and the caches ------------------------------------------------
def test_filtered_pending_and_annex(data, built):
    """Model: tests/unit/test_filters.py:88-110: a filter bites pending and
    annex rows too (both packages, the filters on which they agree)."""
    db, q = data
    j, t = built(**dict(RKW, tile_n=128))
    for s in range(3000, 4000, 250):
        for idx in (j, t):
            idx.add(db[s:s + 250])
    assert t._pending.size and t._annex["n"]
    _same_state(t, j)
    qa = db[3000:3016]
    _, f = _same_scored(t, j, qa, k=5, p_tiles=8, where=np.arange(3000))
    assert (f[f >= 0] < 3000).all()
    _, f2 = _same_scored(t, j, qa, k=5, p_tiles=8, where=np.arange(3000, 4000))
    assert (f2[f2 >= 0] >= 3000).all() and (f2[:, 0] == np.arange(3000, 3016)).all()


def test_filtered_pending_keeps_allowed_rows(data, built):
    """The reference's fault (ivf_band.py:1640-1660, :1944-1963): it filters
    pending and annex rows after their top-k, so when a query's best k
    pending rows are all disallowed it loses the allowed pending row below
    them. The port masks first and returns it, as the exact filtered
    ground truth says; the reference's answer is recorded as it is."""
    db, q = data
    rng = np.random.default_rng(8)
    probe = rng.standard_normal((1, 64)).astype(np.float32)
    probe /= np.linalg.norm(probe)
    near = probe + 0.01 * rng.standard_normal((10, 64)).astype(np.float32)
    allowed_row = probe + 0.05 * rng.standard_normal((1, 64)).astype(np.float32)
    added = np.concatenate([near, allowed_row])
    added /= np.linalg.norm(added, axis=1, keepdims=True)
    j, t = built(**RKW)
    for idx in (j, t):
        idx.add(added)  # ids 3000..3010 pending; 3010 the allowed one
    where = np.r_[0:3000, 3010]
    corpus = np.concatenate([db[:3000], added])
    gt = _surviving_gt(corpus, np.arange(3011), probe, np.arange(3000, 3010))
    assert gt[0, 0] == 3010
    _, it = t.search(probe, 10, p_tiles=8, where=where)
    _, idd = t.search_device(torch.from_numpy(probe), 10, p_tiles=8, where=where)
    _, ij = j.search(probe, 10, p_tiles=8, where=where)
    assert it[0, 0] == 3010 and int(idd[0, 0]) == 3010 and recall_at_k(it, gt) >= 0.9
    assert 3010 not in ij  # the reference loses it


def test_pq_route_filtered_pending_returns_no_disallowed_row(data):
    """The reference's fault on the PQ family's PQ route
    (cloudvectordb_tpu/index/ivf_band.py:3800, :3898): search and
    search_device merge pending rows without the filter, so a filtered
    query near disallowed pending rows gets them back. The port filters
    pending rows before their top-k (``_merge_pending_topk``) and returns
    the allowed pending row; the reference's answer is recorded as it is."""
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex as JaxPQ

    db, _ = data
    rng = np.random.default_rng(9)
    probe = rng.standard_normal((1, 64)).astype(np.float32)
    probe /= np.linalg.norm(probe)
    near = probe + 0.01 * rng.standard_normal((10, 64)).astype(np.float32)
    allowed_row = probe + 0.05 * rng.standard_normal((1, 64)).astype(np.float32)
    added = np.concatenate([near, allowed_row])
    added /= np.linalg.norm(added, axis=1, keepdims=True)
    kw = dict(nlist=16, m=8, nbits=6, tile_n=256, tile_q=16, kmeans_iters=4,
              pq_train_iters=4, refine="none")
    j = JaxPQ.build(db[:3000], **kw)
    t = BandIVFPQIndex.build(db[:3000], centroids=j.centroids, codebooks=j.codebooks,
                             **kw, **CPU)
    for idx in (j, t):
        idx.add(added)  # ids 3000..3010 pending; 3010 the allowed one
    where = np.r_[0:3000, 3010]
    _, it = t.search(probe, 10, p_tiles=8, where=where)
    _, idd = t.search_device(torch.from_numpy(probe), 10, p_tiles=8, where=where)
    _, ij = j.search(probe, 10, p_tiles=8, where=where, interpret=True)
    assert it[0, 0] == 3010 and int(idd[0, 0]) == 3010
    assert np.isin(it, where).all() and np.isin(idd.numpy(), where).all()
    assert np.isin(ij, np.arange(3000, 3010)).any()  # the reference returns disallowed rows


def test_l2_pending_annex_filters_and_remove(data, built):
    """Model: test_l2_band.py:72: an l2 residual index with pending and
    annex rows, searched plain and filtered (a filter on which both agree:
    the added rows allowed), then with its top-1s removed."""
    db, q = data
    j, t = built(**dict(RKW, tile_n=128, metric="l2"))
    for s in range(3000, 4000, 250):
        for idx in (j, t):
            idx.add(db[s:s + 250])
    assert t._annex["n"] and t._pending.size
    _, f = _same_scored(t, j, q, p_tiles=8)
    _same_scored(t, j, db[3000:3016], p_tiles=8, where=np.arange(3000, 4000))
    top1 = np.unique(f[:, 0])
    assert j.remove(top1) == t.remove(top1)
    _same_state(t, j)
    _, f2 = t.search(q, 10, p_tiles=8)
    assert not np.isin(f2, top1).any()


def test_caches_follow_every_mutation(data):
    """The filter mask (keyed on the ids tensor and its version) and the
    l2 bias (the payload and local-id tensors and their versions) after
    each kind of mutation equal masks and biases computed afresh: an
    in-place add and remove (same tensors, new versions), an annex fold
    (arena untouched), an in-place merge and a host merge (new tensors)."""
    db, q = data
    kw = dict(RKW, tile_n=128, metric="l2")
    t = T.build_device_streaming(lambda i: torch.from_numpy(db[i * 1000:(i + 1) * 1000]), 2,
                                 merge_headroom=0.6, **CPU, **kw)
    s = T.build(db[:2000], centroids=t.centroids, slack=0.2, **CPU, **kw)
    flt = IdFilter(np.random.default_rng(2).random(5000) < 0.5)

    def check(idx, stage):
        rm = idx._arena_filter(flt)[0]
        st = idx._device_state()
        fresh = _arena_mask_from_ids(st["ids"], flt.mask_device("cpu"),
                                     n_pad=int(idx._payload.shape[0]))
        assert torch.equal(rm, fresh), stage
        bias = resid_row_bias(st["payload"], st["local"], st["centroid_tiles"], idx._scale,
                              idx.tile_n)
        assert torch.equal(idx._arena_row_bias(), bias), stage
        v, f = idx.search(q, 10, p_tiles=_p_all(idx), where=flt)
        assert flt.allowed_np(f[f >= 0]).all(), stage

    for idx in (t, s):
        check(idx, "built")
    s.add(db[2000:2300])
    assert s._pending.size == 0
    check(s, "in-place add")
    s.remove(np.arange(0, 2300, 3))
    check(s, "in-place remove")
    t.add(db[2000:2700])
    assert t._annex["n"] == 700
    check(t, "annex fold")
    t.merge_pending()
    check(t, "in-place merge")
    t.add(db[2700:4000])
    t.merge_pending()
    check(t, "host merge")


def test_pq_family_keeps_an_empty_pending_buffer(data):
    """BandIVFPQIndex's pending buffer holds its own adds (whole-row int8 at
    its own scale, the codes beside them) and never folds into the base
    annex: past the threshold the fold is a merge. An empty index
    reconstructs nothing and an empty stream builds nothing."""
    db, _ = data
    idx = BandIVFPQIndex(64, 16, m=8, **CPU)
    assert idx._pending.size == 0 and idx._annex is None and idx.ntotal == 0
    with pytest.raises(ValueError):
        idx.reconstruct([0])
    with pytest.raises(ValueError):
        BandIVFPQIndex.build_streaming(iter([]), 16)
    t = BandIVFPQIndex.build(db[:2800], nlist=16, m=8, nbits=6, tile_n=256, tile_q=16,
                             kmeans_iters=4, pq_train_iters=4, refine="none", **CPU)
    t.add(db[2800:3300])
    assert t._pending.size == 500 and t._annex is None and t._pending_scale > 0
    assert sum(c.shape[0] for c in t._pending_codes) == 500
    t.add(db[3300:4000])  # past max(5% of 2800, 4 tiles of 256): the fold merges
    assert t._pending.size == 0 and t._annex is None and t._n == 4000


def test_explicit_ids_and_empty_add(data, built):
    """add(ids=) takes ids at or above the bound; an empty index's first
    add populates it from build()'s quantizer."""
    db, _ = data
    j, t = built(**RKW)
    for idx in (j, t):
        idx.add(db[1000:1010], ids=np.arange(5000, 5010))
    _same_state(t, j)
    assert t._gid_bound() == 5010
    with pytest.raises(ValueError):
        t.add(db[:2], ids=np.array([4, 6000]))
    e = T(64, 16, residual=True, tile_n=256, **CPU)
    e.centroids = t.centroids
    e.add(db[:500])
    assert e.ntotal == 500 and e._pending.size == 0 and e._gid_bound() == 500
