"""parallel/dist_band.py::ShardedBandIndex held to the JAX package's on its
eight simulated CPU devices (Pallas in interpret mode), the same numpy
inputs and the reference's quantizer (``centroids=``), the port's mesh
eight shards on the CPU:

1. per-shard tables equal and arenas byte for byte after the global
   requantization (>= 99.99% of bytes, max |Δ| 1: each shard's scale is an
   f32 mean/max whose summation order differs between frameworks, as
   test_torch_band_index.py says), the global scale exact;
2. ids equal the reference's at full tile coverage (and at partial coverage
   where every shard has as many tiles), scores within 1e-5: residual,
   filtered (no disallowed id; (-inf, -1) tails), top-2, 'precise', l2
   shards, whole int8 rows, the 2-D replica mesh, the streaming build;
3. slack holes keep id -1; add, remove and range search behave as the
   reference's tests ask;
4. the pad-tile case: on shards of unequal tile counts the reference's
   planner spends budget on pad tiles, the port's never (both recorded).
"""

import numpy as np
import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.index.ivf_band import _plan_tiles as jax_plan_tiles
from cloudvectordb_tpu.parallel.dist_band import ShardedBandIndex as JaxShardedBandIndex
from cloudvectordb_tpu.parallel.mesh import make_2d_mesh as jax_make_2d_mesh
from cloudvectordb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.parallel.dist_band import ShardedBandIndex
from cloudvectordb_tpu_torch.parallel.mesh import make_2d_mesh, make_mesh

KW = dict(dtype="int8", kmeans_iters=6, tile_n=128, tile_q=16, seed=5)
SCORE_TOL = 1e-5


def cpu_mesh(n: int = 8):
    return make_mesh(n, devices=["cpu"])


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4096, 64, n_clusters=32, seed=180, normalize=True)
    q = queries_from(db, 32, seed=181, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    return db, q, gt


def build_pair(db, nlist=16, jax_mesh=None, mesh=None, **kw):
    """The reference's build and the port's from its quantizer."""
    j = JaxShardedBandIndex.build(db, nlist=nlist, mesh=jax_mesh or jax_make_mesh(
        axis_name="shard"), **{**KW, **kw})
    t = ShardedBandIndex.build(db, nlist, mesh=mesh or cpu_mesh(), centroids=j._shards[0].centroids,
                               **{**KW, **kw})
    return j, t


@pytest.fixture(scope="module")
def resid(data):
    return build_pair(data[0], residual=True)


def assert_same_search(j, t, q, k=10, floor=1.0, **kw):
    vj, ij = j.search(q, k, **kw)
    vt, it = t.search(q, k, **kw)
    assert ij.shape == it.shape
    assert (ij == it).mean() >= floor, (ij == it).mean()
    same = ij == it
    fin = same & np.isfinite(vj)
    np.testing.assert_allclose(vt[fin], vj[fin], rtol=0, atol=SCORE_TOL)
    return vt, it


def test_arenas_byte_for_byte(resid):
    j, t = resid
    st = j._device_state()
    assert t._scale == j._scale
    assert t._n_tiles() == int(st["n_tiles"])
    pieces = np.asarray(st["payload"]).reshape(8, -1, 64)
    for si, (js, ts) in enumerate(zip(j._shards, t._shards)):
        np.testing.assert_array_equal(ts._ids, np.asarray(js._ids))
        np.testing.assert_array_equal(ts._offsets, js._offsets)
        np.testing.assert_array_equal(ts._tile_window, js._tile_window)
        np.testing.assert_array_equal(ts._local, js._local)
        np.testing.assert_array_equal(ts._valid_end, js._valid_end)
        pt = ts._payload.numpy().astype(np.int16)
        d = np.abs(pieces[si][: pt.shape[0]].astype(np.int16) - pt)
        assert d.max() <= 1 and (d == 0).mean() >= 0.9999, (si, d.max(), (d == 0).mean())
    assert t.ntotal == j.ntotal == 4096


def test_full_coverage_ids_equal_reference(resid, data):
    j, t = resid
    _, q, gt = data
    n_tiles = t._n_tiles()
    _, it = assert_same_search(j, t, q, p_tiles=n_tiles)
    assert recall_at_k(it, gt) >= 0.9
    assert it.min() >= 0 and it.max() < 4096
    # every shard contributes: ids span the partitions
    assert len(set((it // 512).ravel().tolist())) >= 6
    for p in (1, 2):  # every shard has as many tiles: partial coverage agrees too
        assert_same_search(j, t, q, p_tiles=p)
    assert_same_search(j, t, q, nprobe=8)  # the auto budget


def test_filtered_search(resid, data):
    j, t = resid
    _, q, _ = data
    mask = np.random.default_rng(7).random(4096) < 0.4
    n_tiles = t._n_tiles()
    _, it = assert_same_search(j, t, q, p_tiles=n_tiles, where=mask)
    assert mask[it[it >= 0]].all(), "a disallowed id crossed the merge"
    few = np.array([5, 77, 1234])
    v3, i3 = t.search(q, 10, p_tiles=n_tiles, where=few)
    assert set(i3[i3 >= 0].ravel()) <= set(few.tolist())
    assert (i3[:, 3:] == -1).all() and np.isneginf(v3[:, 3:]).all()
    # the bitmap staged on the mesh's device once, where every shard reads it
    flt = t.make_filter(mask)
    staged = flt.staged_for_mesh(t.mesh)
    assert list(staged) == t.mesh.local_devices()
    assert staged[t.device] is flt.mask_device("cpu")


@pytest.mark.parametrize("mode", ["top2", "precise"])
def test_top2_and_precise(resid, data, mode):
    j, t = resid
    _, q, _ = data
    kw = dict(top2=True) if mode == "top2" else dict(scoring="precise")
    vt, it = assert_same_search(j, t, q, k=32 if mode == "top2" else 10,
                                p_tiles=t._n_tiles(), **kw)
    if mode == "top2":
        v1, _ = t.search(q, 32, p_tiles=t._n_tiles())
        assert (vt >= v1 - 1e-5).all()  # the union pool only grows
        for row in range(q.shape[0]):
            ids_row = it[row][vt[row] > -np.inf].tolist()
            assert len(set(ids_row)) == len(ids_row)


def test_l2_shards(data):
    db, q, _ = data
    j, t = build_pair(db, residual=True, metric="l2")
    _, gt = brute_force_topk(db, q, 10, metric="l2")
    _, it = assert_same_search(j, t, q, p_tiles=t._n_tiles())
    assert recall_at_k(it, gt) >= 0.9


def test_whole_rows_and_range_search(data):
    """Whole int8 rows (K3 per shard) equal the reference's; range search
    over the 8-shard merge surfaces a ball wider than one shard's candidate
    pool (checked against the exact oracle, as the reference's test)."""
    db = clustered_vectors(2048, 64, n_clusters=16, seed=190, normalize=True)
    q = queries_from(db, 16, seed=191, normalize=True)
    j, t = build_pair(db)
    n_tiles = t._n_tiles()
    assert_same_search(j, t, q, p_tiles=n_tiles)
    radius = 0.6
    lims, sc, ids = t.range_search(q, radius, k_start=8, p_tiles=n_tiles)
    s_full = q.astype(np.float64) @ db.astype(np.float64).T
    for i in range(q.shape[0]):
        got = set(ids[lims[i]:lims[i + 1]].tolist())
        clear = set(np.flatnonzero(s_full[i] >= radius + 0.05).tolist())
        assert clear <= got, (i, clear - got)
        assert all(s_full[i, g] >= radius - 0.05 for g in got), i
        assert (np.diff(sc[lims[i]:lims[i + 1]]) <= 1e-6).all()


def test_replica_mesh(data):
    """('replica', 'shard') 2 x 4: each replica serves its slice of the
    batch; ids equal the reference's 2-D mesh and the port's 1-D one."""
    db, q, gt = data
    kw = dict(residual=True)
    j, t = build_pair(db, jax_mesh=jax_make_2d_mesh(2, 4),
                      mesh=make_2d_mesh(2, 4, devices=["cpu"]), **kw)
    one = ShardedBandIndex.build(db, 16, mesh=cpu_mesh(4), centroids=j._shards[0].centroids,
                                 **KW, **kw)
    n_tiles = t._n_tiles()
    vt, it = assert_same_search(j, t, q, p_tiles=n_tiles)
    v1, i1 = one.search(q, 10, p_tiles=n_tiles)
    np.testing.assert_array_equal(it, i1)
    np.testing.assert_allclose(vt, v1, rtol=0, atol=SCORE_TOL)
    assert recall_at_k(it, gt) >= 0.9


def test_slack_holes_add_and_remove(data):
    db, q, _ = data
    j, t = build_pair(db[:2048], nlist=8, residual=True, slack=0.3)
    seen = []
    for js, ts in zip(j._shards, t._shards):
        ids = np.asarray(ts._ids, np.int64)
        np.testing.assert_array_equal(ids, np.asarray(js._ids))
        assert (ids < 0).sum() > 0 and (ids[ids < 0] == -1).all()
        seen.append(ids[ids >= 0])
    assert np.unique(np.concatenate(seen)).size == 2048
    assert_same_search(j, t, q, p_tiles=t._n_tiles())

    extra = db[2048:2304]
    before = [sh.ntotal for sh in t._shards]
    ids = t.add(extra)
    np.testing.assert_array_equal(ids, np.arange(2048, 2304))
    np.testing.assert_array_equal(j.add(extra), ids)  # the reference allocates the same
    grew = sorted(a - b for a, b in zip((sh.ntotal for sh in t._shards), before))
    assert grew == [0] * 7 + [256] and t.ntotal == 2304
    _, found = t.search(extra[:16], 1, p_tiles=t._n_tiles())
    assert (found.ravel() >= 2048).mean() >= 0.9  # new rows find themselves
    removed = np.arange(0, 2304, 7)
    assert t.remove(removed) == removed.size == j.remove(removed)
    assert t.ntotal == 2304 - removed.size
    _, found = t.search(q, 10, p_tiles=t._n_tiles())
    assert not np.isin(found, removed).any()
    assert t.remove(removed) == 0
    assert t.add(db[:8]).min() >= 2304  # freed ids never reused


def test_streaming_build(data):
    db, q, gt = data
    chunks = [db[s:s + 512] for s in range(0, 4096, 512)]
    kw = dict(KW, residual=True)
    j = JaxShardedBandIndex.build_streaming(iter(chunks), nlist=16,
                                            mesh=jax_make_mesh(axis_name="shard"), **kw)
    t = ShardedBandIndex.build_streaming(iter(chunks), 16, mesh=cpu_mesh(),
                                         centroids=j._shards[0].centroids, **kw)
    assert t._scale == pytest.approx(j._scale, rel=1e-6)
    for js, ts in zip(j._shards, t._shards):
        np.testing.assert_array_equal(ts._ids, np.asarray(js._ids))
        d = np.abs(np.asarray(js._payload).astype(np.int16) - ts._payload.numpy())
        assert d.max() <= 1 and (d == 0).mean() >= 0.9999
    _, it = assert_same_search(j, t, q, floor=0.99, p_tiles=t._n_tiles())
    assert recall_at_k(it, gt) >= 0.9


def test_pad_tiles_of_unequal_shards(data):
    """4,100 rows on 8 shards: four shards of 513 rows take 5 tiles, four of
    512 take 4. The reference pads those to 5 by repeating the last tile
    window: a pad tile ties with the shard's last real tile, so a query
    group whose best tile is that one also takes the pad tile (masked rows)
    in place of a real tile. The port plans each shard over its real tiles.
    Both behaviours recorded; at full coverage the ids agree."""
    db = clustered_vectors(4100, 64, n_clusters=32, seed=180, normalize=True)
    q = queries_from(db, 64, seed=181, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    j, t = build_pair(db, residual=True)
    counts = [sh._tune_n_tiles() for sh in t._shards]
    assert sorted(set(counts)) == [4, 5]
    assert_same_search(j, t, q, p_tiles=5)
    st = j._device_state()
    short = counts.index(4)
    tw = np.asarray(st["tile_window"])[short]  # (5, W): tile 4 repeats tile 3
    np.testing.assert_array_equal(tw[4], tw[3])
    import jax.numpy as jnp

    sh = t._shards[short]
    _, _, _, table = jax_plan_tiles(jnp.asarray(q), jnp.asarray(sh.centroids),
                                    jnp.asarray(tw), 16, 2)
    table = np.asarray(table)
    took_pad = (table == 4).any(axis=1)
    assert took_pad.any(), "no query group took the pad tile"
    _, ij = j.search(q, 10, p_tiles=2)
    _, it = t.search(q, 10, p_tiles=2)
    assert (ij != it).any()  # the pad tiles cost the reference real tiles
    assert recall_at_k(it, gt) >= recall_at_k(ij, gt)
