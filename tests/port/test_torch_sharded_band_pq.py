"""parallel/dist_band_pq.py::ShardedBandIVFPQIndex held to the JAX package's
on its eight simulated CPU devices, one case for each of
tests/distributed/test_sharded_band_pq.py's, with the same numpy inputs and
the reference's quantizers (``centroids=``, ``codebooks=``,
``codebooks2=``), the port's mesh eight shards on the CPU: ids equal the
reference's on at least ID_FLOOR of the slots and their scores within
SCORE_TOL (the K5 and rescore sums in other orders), with the reference's
own recall rules beside. The segmented-staging case holds the port's
shards, each segmented by its own rows, to the reference's common
segments. Two faults of the reference are
recorded: its unfilled slots carry real ids (the port's are (-inf, -1)),
and its PQ route's unfiltered pending rows (ivf_band.py:3800, :3898) do
not recur across shards, where an add merges at once."""

import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex as JaxBandIVFPQIndex
from cloudvectordb_tpu.parallel.dist_band_pq import ShardedBandIVFPQIndex as JaxSharded
from cloudvectordb_tpu.parallel.mesh import make_2d_mesh as jax_make_2d_mesh
from cloudvectordb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex
from cloudvectordb_tpu_torch.index.registry import load_index
from cloudvectordb_tpu_torch.parallel.dist_band_pq import ShardedBandIVFPQIndex
from cloudvectordb_tpu_torch.parallel.mesh import make_2d_mesh, make_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch here: the tiny CPU shapes gain nothing
    from more, and under several test workers on one machine the extra
    threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


KW = dict(nlist=16, m=8, nbits=4, kmeans_iters=6, pq_train_iters=6, tile_n=256, tile_q=16,
          seed=3)
ID_FLOOR = 0.99
SCORE_TOL = 1e-5


def cpu_mesh(n: int = 8):
    return make_mesh(n, devices=["cpu"])


def quantizers(j) -> dict:
    p = j.proto
    return dict(centroids=np.asarray(p.centroids), codebooks=np.asarray(p.codebooks),
                codebooks2=None if p.codebooks2 is None else np.asarray(p.codebooks2))


def build_pair(db, refine="none", jax_mesh=None, mesh=None, **kw):
    """The reference's sharded build and the port's on its quantizers."""
    kw = {**KW, **kw}
    j = JaxSharded.build(db, mesh=jax_mesh or jax_make_mesh(axis_name="shard"), refine=refine,
                         **kw)
    t = ShardedBandIVFPQIndex.build(db, mesh=mesh or cpu_mesh(), refine=refine,
                                    **quantizers(j), **kw)
    return j, t


def full_p(idx) -> int:
    if isinstance(idx, ShardedBandIVFPQIndex):
        return idx._n_tiles()
    return int(idx._device_state()["n_tiles"])


def assert_same(ref, got, floor=ID_FLOOR):
    (vj, ij), (vt, it) = ref, got
    assert it.shape == ij.shape
    same = ij == it
    assert same.mean() >= floor, same.mean()
    np.testing.assert_allclose(vt[same], vj[same], rtol=0, atol=SCORE_TOL)
    return same.mean()


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4096, 64, n_clusters=32, seed=300, normalize=True)
    q = queries_from(db, 32, seed=301, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    return db, q, gt


@pytest.fixture(scope="module")
def pairs(data):
    """Reference and port builds by refine tier (m2 16 for the tier-2 ones)."""
    cache = {}

    def get(refine):
        if refine not in cache:
            extra = dict(m2=16) if "pq2" in refine else {}
            cache[refine] = build_pair(data[0], refine, **extra)
        return cache[refine]

    return get


def test_sharded_pq_parity_vs_single(data, pairs):
    """The reference's quantizers give the same arenas and, at full
    coverage, the reference's ids; the sharded search recalls at least the
    single index on those quantizers less 0.02 (the reference's rule)."""
    db, q, gt = data
    j, t = pairs("none")
    assert t.ntotal == db.shape[0] and t.nshards == 8
    np.testing.assert_array_equal(t.proto.centroids, np.asarray(j.proto.centroids))
    for si in range(8):
        np.testing.assert_array_equal(t._shards[si]._ids[: t._shards[si]._n],
                                      np.asarray(j._shards[si]._ids))
    ref = j.search(q, 10, p_tiles=full_p(j))
    got = t.search(q, 10, p_tiles=full_p(t))
    assert_same(ref, got)
    single = BandIVFPQIndex.build(db, refine="none", device="cpu", **quantizers(j), **KW)
    _, f1 = single.search(q, 10, p_tiles=single._tune_n_tiles())
    assert recall_at_k(got[1], gt) >= recall_at_k(f1, gt) - 0.02


def test_sharded_pq2_and_cascade_tiers(data, pairs):
    """Every tier equals the reference's (pq2 rescored on each shard by arena
    row, the host tier's two dispatches, the cascade), and the reference's
    recall rules hold: pq2 above 'none', the exact host tier at least pq2,
    the cascade at least pq2 and within 0.02 of the host tier."""
    db, q, gt = data
    skw = dict(p_tiles=full_p(pairs("pq2")[1]), refine_factor=16)
    found = {}
    for refine, extra in (("none", {}), ("pq2", {}), ("host", {}),
                          ("pq2+host", dict(host_factor=6))):
        j, t = pairs(refine)
        kw = dict(p_tiles=skw["p_tiles"]) if refine == "none" else {**skw, **extra}
        got = t.search(q, 10, **kw)
        assert_same(j.search(q, 10, **kw), got)
        found[refine] = recall_at_k(got[1], gt)
    r0, r2, rh, rc = (found[r] for r in ("none", "pq2", "host", "pq2+host"))
    assert r2 >= r0 + 0.02, (r0, r2)
    assert rh >= r2 - 0.01, (r2, rh)
    assert rc >= r2, (r2, rc)
    assert rc >= rh - 0.02, (rh, rc)
    assert rh >= 0.9, rh


def test_sharded_pq2_matches_single_index(data, pairs):
    """The arena-ordered tier-2 rescore recalls what the single index's
    gid-keyed one does on the same quantizers."""
    db, q, gt = data
    j, t = pairs("pq2")
    single = BandIVFPQIndex.build(db, refine="pq2", m2=16, device="cpu", **quantizers(j), **KW)
    _, f1 = single.search(q, 10, p_tiles=single._tune_n_tiles(), refine_factor=16)
    _, f8 = t.search(q, 10, p_tiles=full_p(t), refine_factor=16)
    assert recall_at_k(f8, gt) >= recall_at_k(f1, gt) - 0.02


def test_sharded_pq_save_load_reshard(data, pairs, tmp_path):
    """save -> load is exact; the reference's artifact loads in the port
    and answers as the port's build; a load onto 4 and onto 3 shards
    (codes verbatim, tier stores re-split by membership) keeps recall."""
    db, q, gt = data
    j, t = pairs("pq2")
    skw = dict(p_tiles=full_p(t), refine_factor=16)
    v1, i1 = t.search(q, 10, **skw)
    t.save(tmp_path / "port")
    loaded = load_index(tmp_path / "port", mesh=cpu_mesh())
    assert isinstance(loaded, ShardedBandIVFPQIndex)
    assert loaded.ntotal == t.ntotal and loaded.proto.codebooks2 is not None
    v2, i2 = loaded.search(q, 10, **skw)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2, rtol=1e-5)
    j.save(tmp_path / "ref")
    assert_same((v1, i1), load_index(tmp_path / "ref", mesh=cpu_mesh()).search(q, 10, **skw))
    for s_new in (4, 3):
        re = ShardedBandIVFPQIndex.load(tmp_path / "port", mesh=cpu_mesh(s_new))
        assert re.nshards == s_new and re.ntotal == t.ntotal
        _, i3 = re.search(q, 10, p_tiles=full_p(re), refine_factor=16)
        assert recall_at_k(i3, gt) >= recall_at_k(i1, gt) - 0.02


def test_sharded_pq_cascade_save_load(data, pairs, tmp_path):
    """The cascade round-trips: both tier stores and the mode."""
    db, q, gt = data
    j, t = pairs("pq2+host")
    skw = dict(p_tiles=full_p(t), refine_factor=16, host_factor=6)
    v1, i1 = t.search(q, 10, **skw)
    t.save(tmp_path / "casc")
    loaded = load_index(tmp_path / "casc", mesh=cpu_mesh())
    assert loaded.refine == "pq2+host"
    assert loaded.proto._host_scale == pytest.approx(t.proto._host_scale)
    v2, i2 = loaded.search(q, 10, **skw)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2, rtol=1e-5)



def id_tiers(idx):
    """Each global id's tier-1 codes and list (its shard's arena) and its
    tier-2 codes, host row and host list (its shard's tier stores), in gid
    order."""
    parts = []
    for si, sh in enumerate(idx._shards):
        st, perm = idx._tier_store(si), idx._arena_perm(si)
        parts.append((np.asarray(sh._ids, np.int64)[: sh._n], sh._codes[: sh._n].numpy(),
                      np.searchsorted(sh._offsets, np.arange(sh._n), side="right") - 1,
                      st["c2"][perm], st["host"][perm], st["assign"][perm]))
    order = np.argsort(np.concatenate([p[0] for p in parts]))
    return [np.concatenate([p[j] for p in parts])[order] for j in range(6)]


def test_sharded_pq_cascade_reshard_keeps_every_ids_tiers(data, pairs, tmp_path):
    """A cascade resharded 8 -> 3 carries every id once, with the same
    tier-1 codes and list, tier-2 codes, host row and host list: the tier
    stores re-split by membership follow their rows."""
    db, _, _ = data
    _, t = pairs("pq2+host")
    t.save(tmp_path / "casc")
    re = ShardedBandIVFPQIndex.load(tmp_path / "casc", mesh=cpu_mesh(3))
    before, after = id_tiers(t), id_tiers(re)
    np.testing.assert_array_equal(before[0], np.arange(db.shape[0]))
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(after[2], after[5])


def test_sharded_pq_add_remove(data):
    """Adds take wrapper-allocated global ids on the smallest shard, their
    tier payloads in the wrapper's stores, as the reference's; removes fan
    out by id; freed ids are never reused. A filter that refuses the added
    rows returns none of them in either package (the pending rows' fault of
    the reference's PQ route does not recur: an add merges at once)."""
    db, q, _ = data
    j, t = build_pair(db[:4000], "pq2", m2=16)
    gj, gt_ = j.add(db[4000:4096]), t.add(db[4000:4096])
    np.testing.assert_array_equal(gj, gt_)
    assert t.ntotal == 4096 and gt_.min() >= 4000
    skw = dict(p_tiles=full_p(t), refine_factor=16)
    got = t.search(db[4000:4008], 1, **skw)
    assert_same(j.search(db[4000:4008], 1, **skw), got)
    assert (got[1][:, 0] == gt_[:8]).mean() >= 0.9
    assert_same(j.search(q, 10, **skw), t.search(q, 10, **skw))
    where = np.arange(4000)
    for idx in (j, t):
        _, f = idx.search(db[4000:4008], 10, where=where, **skw)
        assert not np.isin(f, gt_).any()
    assert t.remove(gt_[:50]) == 50 and j.remove(gj[:50]) == 50
    assert t.ntotal == 4000 + 46
    _, f2 = t.search(db[4000:4008], 1, **skw)
    assert not np.isin(f2[:, 0], gt_[:50]).any()
    assert_same(j.search(q, 10, **skw), t.search(q, 10, **skw))
    g3 = t.add(db[:8])
    assert g3.min() >= gt_.max() + 1


def test_sharded_pq_filtered_search(data, pairs):
    """where=: each shard's K5 masks its arena rows (the single index's
    cached mask); no disallowed id, the reference's ids, and the
    reference's rule against the single index's filtered search."""
    db, q, _ = data
    j, t = pairs("pq2")
    allow = np.random.default_rng(7).random(db.shape[0]) < 0.5
    allowed = np.flatnonzero(allow)
    _, gt_f = brute_force_topk(db[allow], q, 10, metric="ip")
    gt_f = allowed[gt_f]
    skw = dict(p_tiles=full_p(t), refine_factor=16, where=allowed)
    got = t.search(q, 10, **skw)
    live = got[1][got[1] >= 0]
    assert np.isin(live, allowed).all()
    assert_same(j.search(q, 10, **skw), got)
    single = BandIVFPQIndex.build(db, refine="pq2", m2=16, device="cpu", **quantizers(j), **KW)
    _, f1 = single.search(q, 10, p_tiles=single._tune_n_tiles(), refine_factor=16, where=allowed)
    assert recall_at_k(got[1], gt_f) >= recall_at_k(f1, gt_f) - 0.03


@pytest.mark.parametrize("refine", ["pq2", "pq2+host"])
def test_sharded_pq_l2_metric(data, refine):
    """metric='l2' through the shards (K5's l2 key over each shard's bias,
    the s₂ table in arena order, the host tier's ‖x̂‖²): the reference's ids
    and its rules against the single index."""
    db, q, _ = data
    _, gt_l2 = brute_force_topk(db, q, 10, metric="l2")
    extra = {"host_factor": 8} if refine == "pq2+host" else {}
    j, t = build_pair(db, refine, m2=16, metric="l2")
    skw = dict(p_tiles=full_p(t), refine_factor=16, **extra)
    got = t.search(q, 10, **skw)
    assert_same(j.search(q, 10, **skw), got)
    single = BandIVFPQIndex.build(db, refine="pq2", m2=16, metric="l2", device="cpu",
                                  **quantizers(j), **KW)
    _, f1 = single.search(q, 10, p_tiles=single._tune_n_tiles(), refine_factor=16)
    r1, r = recall_at_k(f1, gt_l2), recall_at_k(got[1], gt_l2)
    assert r >= r1 - 0.02, (r, r1)
    if refine == "pq2+host":  # the exact tail beats tier-2 ranking
        assert r >= r1 + 0.02, (r, r1)


def test_sharded_pq_segmented_matches_the_reference(data, monkeypatch, tmp_path):
    """Shards past seg_rows_cap (here one tile, so two segments a shard):
    the reference stages common segments over the largest shard's rows, the
    port segments each shard by its own, at the same boundaries (multiples
    of the cap from row 0), so K5's pools are the same and the ids are the
    reference's segmented search's. The reference's artifact (its shards saved as one
    row-major matrix each) loads here segmented, with the same ids."""
    db, q, gt = data
    monkeypatch.setattr(JaxBandIVFPQIndex, "seg_rows_cap", KW["tile_n"])
    monkeypatch.setattr(BandIVFPQIndex, "seg_rows_cap", KW["tile_n"])
    j, t = build_pair(db, "pq2", m2=16)
    assert j._common_layout()[4] is True  # segmented
    assert all(sh._segmented for sh in t._shards)
    skw = dict(p_tiles=full_p(t), refine_factor=16)
    ref = j.search(q, 10, **skw)
    got = t.search(q, 10, **skw)
    assert_same(ref, got)
    assert recall_at_k(got[1], gt) >= recall_at_k(ref[1], gt) - 0.005
    j.save(tmp_path / "seg")
    loaded = load_index(tmp_path / "seg", mesh=cpu_mesh())
    assert all(sh._segmented for sh in loaded._shards)
    np.testing.assert_array_equal(loaded.search(q, 10, **skw)[1], got[1])


def test_sharded_pq_2d_mesh(data):
    """('replica', 'shard'): each replica serves its slice of the queries
    over its shards; the same ids as the 1-D mesh of 4 shards and as the
    reference's 2-D mesh."""
    db, q, _ = data
    j, one = build_pair(db, "pq2", jax_mesh=jax_make_mesh(4, axis_name="shard"),
                        mesh=cpu_mesh(4), m2=16)
    j2 = JaxSharded.build(db, mesh=jax_make_2d_mesh(2, 4), refine="pq2", m2=16, **KW)
    two = ShardedBandIVFPQIndex.build(db, mesh=make_2d_mesh(2, 4, devices=["cpu"]),
                                      refine="pq2", m2=16, **quantizers(j), **KW)
    skw = dict(p_tiles=full_p(one), refine_factor=16)
    got = two.search(q, 10, **skw)
    np.testing.assert_array_equal(got[1], one.search(q, 10, **skw)[1])
    assert_same(j2.search(q, 10, **skw), got)


def test_sharded_pq_tune(data, pairs):
    """tune(gt=) walks the cascade ladder to an op point meeting 0.9, which
    search() then serves by default."""
    db, q, gt = data
    _, t = pairs("pq2+host")
    report = t.tune(q, k=10, target_recall=0.9, gt=gt)
    assert report["met"], report
    assert recall_at_k(t.search(q, 10)[1], gt) >= 0.88
    t._op_point = None


def test_unfilled_slots(data):
    """A query short of candidates (64 rows, k 80): the reference fills the
    tail with -inf scores and real ids (a shard's id table through clipped
    rows, no filter given); the port returns (-inf, -1) there, and the same
    ids in the filled slots."""
    db = clustered_vectors(64, 64, n_clusters=4, seed=300, normalize=True)
    q = queries_from(db, 4, seed=301, normalize=True)
    kw = dict(KW, nlist=2, kmeans_iters=4, pq_train_iters=4)
    j = JaxSharded.build(db, mesh=jax_make_mesh(2, axis_name="shard"), **kw)
    t = ShardedBandIVFPQIndex.build(db, mesh=cpu_mesh(2), **quantizers(j), **kw)
    vj, ij = j.search(q, 80, p_tiles=1)
    vt, it = t.search(q, 80, p_tiles=1)
    tail = vt == -np.inf
    assert tail.sum() == 4 * 16 and (vj == -np.inf).sum() == tail.sum()
    assert (it[tail] == -1).all() and (ij[tail] >= 0).all()
    assert_same((vj[~tail], ij[~tail]), (vt[~tail], it[~tail]))


def test_sharded_pq_range_search(data, pairs):
    """range_search (RangeSearchMixin's k-escalation over search) returns the
    reference's hits: the same CSR offsets, ids and scores."""
    db, q, _ = data
    j, t = pairs("pq2")
    skw = dict(p_tiles=full_p(t), refine_factor=16, k_start=8, k_max=64)
    lj, sj, ij = j.range_search(q, 0.75, **skw)
    lt, st, it = t.range_search(q, 0.75, **skw)
    assert lt[-1] > q.shape[0]  # a real range: more hits than queries
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, rtol=0, atol=SCORE_TOL)


def test_sharded_pq_top2(data, pairs):
    """top2=: two slots a bucket in every shard's K5, the reference's ids."""
    db, q, _ = data
    j, t = pairs("pq2")
    skw = dict(p_tiles=2, refine_factor=64, top2=True)
    assert_same(j.search(q, 10, **skw), t.search(q, 10, **skw))
