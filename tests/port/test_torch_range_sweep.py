"""Range search, the nprobe sweep and the host list arena: the port held to
the reference on the same numpy inputs.

Tolerances: range hits as the reference's (the same ids per query; scores
within 1e-5, f32 scans in two frameworks); sweep recalls within 0.01 (the
same index state, ids equal apart from near-ties) and the same operating
point;
``ListArena`` and ``grow_scatter_gid`` byte for byte.

1. ``RangeSearchMixin`` on ``FlatIndex`` (ip and l2, the squared-distance
   radius), ``IVFFlatIndex`` (at full probe, where it is exact) and the
   residual ``BandIVFIndex`` (k-escalation through its tiles search).
2. ``nprobe_sweep`` and ``operating_point`` on IVF-Flat.
3. ``ListArena``: rebuild, merge, remove_ids, list_lens, max_list_len;
   ``grow_scatter_gid``.
"""

import numpy as np
import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.eval.sweep import nprobe_sweep as jax_nprobe_sweep
from cloudvectordb_tpu.eval.sweep import operating_point as jax_operating_point
from cloudvectordb_tpu.index.arena import ListArena as JaxListArena
from cloudvectordb_tpu.index.arena import grow_scatter_gid as jax_grow_scatter_gid
from cloudvectordb_tpu.index.flat import FlatIndex as JaxFlatIndex
from cloudvectordb_tpu.index.ivf_band import BandIVFIndex as JaxBandIVFIndex
from cloudvectordb_tpu.index.ivf_flat import IVFFlatIndex as JaxIVFFlatIndex
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk
from cloudvectordb_tpu_torch.eval.sweep import nprobe_sweep, operating_point
from cloudvectordb_tpu_torch.index.arena import ListArena, grow_scatter_gid
from cloudvectordb_tpu_torch.index.flat import FlatIndex
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex
from cloudvectordb_tpu_torch.index.ivf_flat import IVFFlatIndex

D, NLIST = 32, 16


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(2000, D, n_clusters=16, seed=140, normalize=True)
    q = queries_from(db, 24, seed=141, normalize=True)
    return db, q


def _flat(db, metric):
    return JaxFlatIndex.build(db, metric=metric), FlatIndex.build(db, metric=metric,
                                                                  device="cpu")


def _ivf_flat(db, metric):
    j = JaxIVFFlatIndex.build(db, nlist=NLIST, metric=metric, kmeans_iters=4)
    return j, IVFFlatIndex.build(db, NLIST, metric=metric, centroids=j.centroids,
                                 device="cpu")


def _band(db, metric):
    kw = dict(nlist=NLIST, dtype="int8", residual=True, kmeans_iters=4, tile_n=256,
              tile_q=8)
    j = JaxBandIVFIndex.build(db, **kw)
    return j, BandIVFIndex.from_state(j._state_meta(), j._state_arrays(), device="cpu")


#: (family, metric, search kwargs)
CASES = [(_flat, "ip", {}), (_flat, "l2", {}), (_ivf_flat, "ip", {"nprobe": NLIST}),
         (_ivf_flat, "l2", {"nprobe": NLIST}), (_band, "ip", {"p_tiles": 8})]


@pytest.mark.parametrize("family, metric, kw", CASES,
                         ids=[f"{c[0].__name__[1:]}-{c[1]}" for c in CASES])
def test_range_search_is_the_reference(data, family, metric, kw):
    db, q = data
    j, t = family(db, metric)
    # the median 12th exact score: half the queries escalate past k_start
    # (ip radii are scores, l2 radii squared distances)
    s12 = float(np.median(brute_force_topk(db, q, 12, metric=metric)[0][:, -1]))
    radius = -s12 if metric == "l2" else s12
    lj, sj, ij = j.range_search(q, radius, k_start=4, **kw)
    lt, st, it = t.range_search(q, radius, k_start=4, **kw)
    assert lt.dtype == np.int64 and it.dtype == np.int64
    np.testing.assert_array_equal(lt, lj)
    assert lt[-1] > 0 and np.diff(lt).max() > 4  # hits, some past k_start: escalated
    for a in range(len(lt) - 1):
        rows = slice(lt[a], lt[a + 1])
        assert set(it[rows].tolist()) == set(ij[rows].tolist())
        assert (np.diff(st[rows]) <= 0).all()
    np.testing.assert_allclose(np.sort(st), np.sort(sj), atol=1e-5, rtol=0)
    thresh = -radius if metric == "l2" else radius
    assert (st >= thresh).all()


def test_range_search_on_an_empty_index():
    lims, s, i = FlatIndex(D, device="cpu").range_search(np.zeros((3, D), np.float32), 0.5)
    assert lims.tolist() == [0, 0, 0, 0] and s.size == i.size == 0


def test_nprobe_sweep_and_operating_point(data):
    db, q = data
    j, t = _ivf_flat(db, "ip")
    _, gt = brute_force_topk(db, q, 10)
    kw = dict(k=10, nprobes=(1, 2, 4, 16), batch=8, time_iters=1, gt_ids=gt)
    sj = jax_nprobe_sweep(j, db, q, **kw)
    st = nprobe_sweep(t, db, q, **kw)
    assert [r["nprobe"] for r in st] == [r["nprobe"] for r in sj]
    np.testing.assert_allclose([r["recall"] for r in st], [r["recall"] for r in sj],
                               atol=0.01)
    assert all(r["qps"] > 0 and r["latency_ms"] > 0 for r in st)
    assert st[-1]["recall"] >= 0.9999  # full probe: the sweep stops there
    for floor in (0.5, 0.9, 1.0):
        pj, pt = jax_operating_point(sj, floor), operating_point(st, floor)
        assert (pt is None) == (pj is None) and (pt is None or pt["nprobe"] == pj["nprobe"])
    assert operating_point(st, 1.01) is None
    # no gt: the sweep computes the exact one itself
    assert nprobe_sweep(t, db, q, k=10, nprobes=(16,), batch=8, time_iters=1)[0]["recall"] == 1.0


def test_list_arena_is_the_reference():
    rng = np.random.default_rng(142)
    nlist = 12
    arenas = (JaxListArena(nlist, 5, np.float32), ListArena(nlist, 5, np.float32))
    assert all(a.size == 0 and a.max_list_len == 0 for a in arenas)
    for step in range(3):  # rebuild through merge into an empty arena, then merges
        n = 300 + 50 * step
        p = rng.normal(size=(n, 5)).astype(np.float32)
        ids = np.arange(1000 * step, 1000 * step + n, dtype=np.int64)
        a = rng.integers(0, nlist - 2, size=n)  # the last two lists stay empty
        for arena in arenas:
            arena.merge(p, ids, a)
    req = np.unique(rng.choice(np.concatenate([ar.ids for ar in arenas[:1]]), 200))
    assert arenas[0].remove_ids(req) == arenas[1].remove_ids(req) == req.size
    assert arenas[1].remove_ids(req) == 0
    jr, tr = arenas
    for name in ("payload", "ids", "offsets", "list_lens"):
        a, b = np.asarray(getattr(jr, name)), getattr(tr, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert tr.max_list_len == jr.max_list_len and tr.size == jr.size
    fresh = ListArena(nlist, 5, np.float32)
    fresh.rebuild(tr.payload, tr.ids, np.repeat(np.arange(nlist), tr.list_lens))
    assert fresh.payload.tobytes() == tr.payload.tobytes()


@pytest.mark.parametrize("hi", [0, 40])
def test_grow_scatter_gid_is_the_reference(hi):
    rng = np.random.default_rng(143)
    base = rng.integers(-127, 128, size=(hi, 6)).astype(np.int8)
    gids = np.array([3, 77, 41, 90], np.int64)
    rows = rng.integers(-127, 128, size=(4, 6)).astype(np.int8)
    want = jax_grow_scatter_gid(base, rows, gids)
    got = grow_scatter_gid(base, rows, gids)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert got is not base and got.shape == (91, 6)
