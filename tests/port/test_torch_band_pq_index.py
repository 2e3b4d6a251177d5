"""BandIVFPQIndex: the port held to the reference on the same data and the
same quantizers.

1. Both packages build from one quantizer set (the reference trains it; the
   port takes its centroids, codebooks and OPQ matrix), through ``build``
   and through ``build_device_streaming``. Offsets, ids, codes (the
   reference's code-major arena transposed), local bytes, tile_n and the
   tile window must be equal byte for byte; the refine rows equal on >=
   99.99% of bytes with max |Δ| <= 1 and the scale within 1e-6 relative
   (the scale is an f32 mean/max whose summation order differs between the
   frameworks, so it can differ in its last ulp and move a row by one step
   at a rounding edge).
2. ``search`` and ``search_device`` (serve_from 'pq' and 'refine'; refine
   'int8' and 'none'; residual on and off; OPQ on and off; top-2; auto and
   explicit pools) return the same ids on >= 0.999 of slots, a differing
   id only where the two scores agree within 1e-5, and recall@10 against
   the exact ground truth within 0.005 of the reference's.
3. Artifacts load both ways (the reference's code-major host-build layout,
   its row-major device-build layout, the port's row-major one) and search
   alike; the ``_tune_candidates`` ladders are equal, ``tune()`` runs, and
   the tuners of both packages prune the same candidates.
4. The refine tiers 'pq2' (ip and l2), 'host' and the 'pq2+host' cascade,
   ``metric='l2'`` on both routes, anisotropic codebooks and filtered search
   (``where=``, both routes, search and search_device): the gid-keyed tier
   stores byte for byte (tier-2 codes; host rows as the refine rows; s₂
   within 1e-5 relative), searches as in 2, artifacts both ways.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.index.pq import pq_encode_aniso as jax_pq_encode_aniso
from cloudvectordb_tpu.eval import tune as jax_tune
from cloudvectordb_tpu.index import load_index as jax_load_index
from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex as JaxPQ
from cloudvectordb_tpu_torch.eval import tune
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex
from cloudvectordb_tpu_torch.index.pq import pq_encode_aniso
from cloudvectordb_tpu_torch.index.registry import load_index

KW = dict(nlist=16, m=8, nbits=6, kmeans_iters=6, pq_train_iters=6, tile_n=256, tile_q=16)
#: (refine, residual): residual-int8 refine, whole-row int8 refine, no refine
BUILDS = {"resid_int8": ("int8", True), "whole_int8": ("int8", False),
          "resid_none": ("none", True)}
#: the tiers, l2 and anisotropic codebooks: name -> (build kwargs, l2 data)
TIER_BUILDS = {
    "pq2": (dict(refine="pq2", m2=16), False),
    "pq2_l2": (dict(refine="pq2", m2=16, metric="l2"), True),
    "host": (dict(refine="host"), False),
    "int8_l2": (dict(refine="int8", metric="l2", opq=True), True),
    "host_l2": (dict(refine="host", metric="l2", residual=False), True),
    "aniso": (dict(refine="none", aniso_eta=4.0), False),
}


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4000, 64, n_clusters=32, seed=90, normalize=True)
    q = queries_from(db, 48, seed=91, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    return db, q, gt


@pytest.fixture(scope="module")
def jax_builds(data):
    """The reference's indexes, built once each."""
    cache = {}

    def get(name):
        if name not in cache:
            refine, residual = BUILDS[name]
            cache[name] = JaxPQ.build(data[0], refine=refine, residual=residual, **KW)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def jax_streamed(data):
    """The reference's device-streaming build, config #3's path at a small
    size: OPQ, residual, int8 refine."""
    db = data[0]
    return JaxPQ.build_device_streaming(
        lambda i: jnp.asarray(db[i * 1000:(i + 1) * 1000]), 4, opq=True, refine="int8",
        train_sample=1000, **KW)


@pytest.fixture(scope="module")
def l2_data():
    """Rows of the same process with norms spread over [0.5, 3.0], so that
    the l2 and ip rankings differ; the exact l2 ground truth."""
    db = clustered_vectors(4000, 64, n_clusters=32, seed=92, normalize=True)
    db = db * np.random.default_rng(93).uniform(0.5, 3.0, (4000, 1)).astype(np.float32)
    q = queries_from(db, 48, seed=94, normalize=False)
    _, gt = brute_force_topk(db, q, 10, metric="l2")
    return db, q, gt


@pytest.fixture(scope="module")
def tier_builds(data, l2_data):
    """The reference's tier, l2 and anisotropic indexes, built once each."""
    cache = {}

    def get(name):
        if name not in cache:
            kw, l2 = TIER_BUILDS[name]
            rows = (l2_data if l2 else data)[0]
            cache[name] = JaxPQ.build(rows, **{**KW, **kw})
        return cache[name]

    return get


def _same_quantizers(j) -> dict:
    return dict(centroids=j.centroids, codebooks=j.codebooks, opq_matrix=j.opq_matrix,
                refine=j.refine, residual=j.residual, metric=j.metric, m2=j.m2,
                codebooks2=j.codebooks2, aniso_eta=j.aniso_eta)


def _assert_same_tiers(t, j):
    """The gid-keyed tier stores: tier-2 codes byte for byte, s₂ within
    1e-5 relative, host rows as the refine rows (their scale an f32 mean/max
    of another summation order), the host assignments exactly."""
    if j._tier2_active:
        np.testing.assert_array_equal(t._codes2_device().numpy(), np.asarray(j._codes2_device()))
        np.testing.assert_allclose(t.codebooks2, j.codebooks2)
        if j.metric == "l2":
            s2_j = np.asarray(j._s2_device())
            np.testing.assert_allclose(t._s2_device().numpy(), s2_j, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(s2_j).max()))
    if j._host_active:
        rows_j, asg_j = j._host_store()
        rows_t, asg_t = t._host_store()
        np.testing.assert_array_equal(asg_t, asg_j)
        diff = np.abs(rows_t.astype(np.int16) - rows_j.astype(np.int16))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.9999, (diff.max(), (diff == 0).mean())
        assert t._host_scale == pytest.approx(j._host_scale, rel=1e-6)


def _jax_arena(j):
    """(codes (N_pad, m), local (N_pad,) or None) of a reference index."""
    cm = np.asarray(j._codes_cm)
    if j._codes_row_major:
        local = np.asarray(j._local_rm)[0] if j.residual else None
        return cm[:, : j.m], local
    return cm[: j.m].T, (cm[j.m] if j.residual else None)


def _assert_same_arena(t, j):
    codes_j, local_j = _jax_arena(j)
    np.testing.assert_array_equal(t._offsets, j._offsets)
    np.testing.assert_array_equal(t._ids, np.asarray(j._ids))
    np.testing.assert_array_equal(t._codes.numpy(), codes_j)
    if j.residual:
        np.testing.assert_array_equal(t._local.numpy(), local_j)
    else:
        assert t._local is None
    np.testing.assert_array_equal(t._tile_window, j._tile_window)
    assert (t.tile_n, t._n_pad_rows, t._n, t.ntotal) == (j.tile_n, j._n_pad_rows, j._n, j.ntotal)
    rj = np.asarray(j._refine_rows).astype(np.int16)
    rt = t._refine_rows.numpy().astype(np.int16)
    assert rj.shape == rt.shape
    diff = np.abs(rj - rt)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.9999, (diff.max(), (diff == 0).mean())
    assert t._scale == pytest.approx(j._scale, rel=1e-6)


def _assert_same_results(vt, it, vj, ij, gt):
    """Ids equal on >= 0.999 of slots, and slot by slot the scores agree, so
    an id that differs is a tie."""
    vt, it, vj, ij = (np.asarray(a) for a in (vt, it, vj, ij))
    assert it.shape == ij.shape and (it == ij).mean() >= 0.999, (it != ij).sum()
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-5)
    assert abs(recall_at_k(it, gt) - recall_at_k(ij, gt)) <= 0.005


def _assert_same_search(t, j, q, gt, device=False, **kw):
    if device:
        vj, ij = j.search_device(jnp.asarray(q), 10, interpret=True, **kw)
        vt, it = t.search_device(torch.from_numpy(q), 10, **kw)
        assert it.dtype == torch.int32
    else:
        vj, ij = j.search(q, 10, interpret=True, **kw)
        vt, it = t.search(q, 10, **kw)
    _assert_same_results(vt, it, vj, ij, gt)


#: per build, the searches held to the reference (auto and explicit pools,
#: top-2, both routes, host and device entry points)
SEARCHES = {
    "resid_int8": [dict(p_tiles=16), dict(p_tiles=4, refine_factor=64, top2=True),
                   dict(p_tiles=6, serve_from="refine", device=True)],
    "whole_int8": [dict(p_tiles=4, refine_factor=64, n_pools=3),
                   dict(p_tiles=8, device=True)],
    "resid_none": [dict(p_tiles=5, n_pools=2, top2=True), dict(p_tiles=16)],
}


@pytest.mark.parametrize("name", list(BUILDS))
def test_build_parity(data, jax_builds, name):
    db, q, gt = data
    j = jax_builds(name)
    t = BandIVFPQIndex.build(db, device="cpu", **dict(KW, **_same_quantizers(j)))
    _assert_same_arena(t, j)
    for kw in SEARCHES[name]:
        _assert_same_search(t, j, q, gt, **kw)
    assert t._tune_candidates(q.shape[0]) == j._tune_candidates(q.shape[0])
    assert t._tune_reference_kw(q.shape[0]) == j._tune_reference_kw(q.shape[0])


def test_device_streaming_parity(data, jax_streamed):
    """BASELINE config #3's path: OPQ, residual PQ, residual-int8 refine."""
    db, q, gt = data
    j = jax_streamed
    assert j.opq_matrix is not None
    t = BandIVFPQIndex.build_device_streaming(
        lambda i: torch.from_numpy(db[i * 1000:(i + 1) * 1000]), 4, train_sample=1000,
        device="cpu", **dict(KW, **_same_quantizers(j)))
    _assert_same_arena(t, j)
    _assert_same_search(t, j, q, gt, device=True, p_tiles=4, refine_factor=16)
    _assert_same_search(t, j, q, gt, device=True, p_tiles=4, refine_factor=64, top2=True)
    _assert_same_search(t, j, q[:45], gt[:45], p_tiles=6, serve_from="refine")


def test_artifacts_load_both_ways(data, jax_builds, jax_streamed, tmp_path):
    db, q, gt = data
    for name, j in (("host_build", jax_builds("resid_int8")), ("device_build", jax_streamed)):
        j.save(tmp_path / name)
        t = load_index(tmp_path / name, device="cpu")
        assert isinstance(t, BandIVFPQIndex)
        _assert_same_arena(t, j)
        assert t._scale == j._scale
        _assert_same_search(t, j, q, gt, p_tiles=4, refine_factor=64)
    t._op_point = {"p_tiles": 6, "tile_q": 16, "serve_from": "refine"}
    t.save(tmp_path / "port")
    j2 = jax_load_index(tmp_path / "port")
    assert j2._op_point == t._op_point and j2._codes_row_major
    _assert_same_arena(t, j2)
    _assert_same_search(t, j2, q, gt, p_tiles=4, refine_factor=16)
    _assert_same_search(t, j2, q, gt)  # both serve the saved op point
    t2 = BandIVFPQIndex.from_state(j2._state_meta(), j2._state_arrays(), device="cpu")
    np.testing.assert_array_equal(t2.search(q, 10, **t._op_point)[1], t.search(q, 10)[1])


def test_tune_runs_and_prunes_as_the_reference(data, jax_builds):
    db, q, gt = data
    j = jax_builds("whole_int8")
    t = BandIVFPQIndex.build(db, device="cpu", **dict(KW, **_same_quantizers(j)))
    ladder = t._tune_candidates(q.shape[0])
    assert any("refine_factor" in c for c in ladder) and any(c.get("top2") for c in ladder)
    # the prune bound of the walk: both packages' proxies, candidate by candidate
    for cfg in ladder:
        assert tune._proxy_cost(cfg) == jax_tune._proxy_cost(cfg)
    first = ladder[0]
    pruned = [c for c in ladder if tune._proxy_cost(c) > 4.0 * tune._proxy_cost(first)]
    assert pruned == [c for c in ladder
                      if jax_tune._proxy_cost(c) > 4.0 * jax_tune._proxy_cost(first)]
    report = t.tune(q, k=10, target_recall=0.9, gt=gt)
    assert report["met"] and t._op_point == report["op"]
    floor = min(tune._proxy_cost(f["op"]) for f in report["finalists"])
    assert all(tune._proxy_cost(r) > 4.0 * floor
               for r in report["tried"] if "skipped" in r)
    _, found = t.search(q, 10)  # no knobs: the op point serves
    assert recall_at_k(found, gt) >= 0.85


def test_unported_options_raise(data, jax_builds):
    """Every option the PQ family once refused now constructs; what the
    reference refuses still raises ValueError: an unknown refine tier or
    metric, the refine route without refine rows, the host tier on the
    device entry point, the host tier's attach without a streaming build's
    assignments, explicit ids a tier store cannot append."""
    for opt in (dict(refine="pq2"), dict(refine="host"), dict(refine="pq2+host"),
                dict(metric="l2"), dict(aniso_eta=4.0)):
        idx = BandIVFPQIndex(64, 16, m=8, device="cpu", **opt)
        assert idx.ntotal == 0 and idx._pending.size == 0
    for bad in (dict(refine="int4"), dict(metric="cosine"), dict(m2=7)):
        with pytest.raises(ValueError):
            BandIVFPQIndex(64, 16, m=8, device="cpu", **bad)
    j = jax_builds("resid_none")
    t = BandIVFPQIndex.build(data[0], device="cpu", **dict(KW, **_same_quantizers(j)))
    with pytest.raises(ValueError):  # no refine rows to scan
        t.search(data[1], 10, serve_from="refine")
    with pytest.raises(ValueError):  # built by build(): no gid-keyed assignments
        t.attach_host_refine(lambda i: data[0], 1)
    h = BandIVFPQIndex.build(data[0][:2000], refine="host", device="cpu",
                             **dict(KW, centroids=j.centroids, codebooks=j.codebooks))
    with pytest.raises(ValueError, match="host"):
        h.search_device(torch.from_numpy(data[1]), 10, refine_factor=4)
    with pytest.raises(ValueError, match="non-consecutive"):
        h.add(data[0][2000:2004], ids=np.arange(5000, 5004))


@pytest.mark.parametrize("route", ["pq", "refine"])
def test_filters_and_l2_still_refused(data, jax_builds, route):
    """where= on both routes (K5 masked on the PQ route, K1 masked on the
    refine route), search and search_device, against the reference: a
    random 40% filter and a correlated one (every row of four adjacent
    lists, so that the plan drops dead tiles); no disallowed id, unfilled
    slots (-inf, -1); the filter mask cached per filter and arena state."""
    db, q, gt = data
    j = jax_builds("resid_int8")
    t = BandIVFPQIndex.build(db, device="cpu", **dict(KW, **_same_quantizers(j)))
    rand = np.random.default_rng(5).random(db.shape[0]) < 0.4
    corr = np.zeros(db.shape[0], bool)
    corr[np.asarray(j._ids)[j._offsets[4]:j._offsets[8]]] = True
    few = np.zeros(db.shape[0], bool)
    few[[4, 44, 444]] = True
    kw = dict(p_tiles=6, refine_factor=16, serve_from=route)
    for mask in (rand, corr, few):
        vj, ij = j.search(q, 10, interpret=True, where=mask, **kw)
        flt = t.make_filter(mask)
        vt, it = t.search(q, 10, where=flt, **kw)
        _assert_same_results(vt, it, vj, ij, gt)
        assert mask[it[it >= 0]].all() and np.isneginf(vt[it < 0]).all()
        vd, idd = t.search_device(torch.from_numpy(q), 10, where=flt, **kw)
        np.testing.assert_array_equal(idd.numpy(), it)
        assert t._arena_filter(flt)[0] is t._arena_filter(flt)[0]
    assert (it < 0).any()  # three allowed rows leave every query short


@pytest.mark.parametrize("name", list(TIER_BUILDS))
def test_tier_l2_and_aniso_parity(data, l2_data, tier_builds, name):
    """Each tier, l2 and anisotropic build against the reference: the arena
    and the tier stores, then search (both routes where they exist) and
    search_device, filtered and not."""
    kw, l2 = TIER_BUILDS[name]
    db, q, gt = l2_data if l2 else data
    j = tier_builds(name)
    t = BandIVFPQIndex.build(db, device="cpu", **dict(KW, **_same_quantizers(j)))
    _assert_same_arena(t, j)
    _assert_same_tiers(t, j)
    _assert_same_search(t, j, q, gt, p_tiles=6, refine_factor=16)
    mask = np.random.default_rng(6).random(db.shape[0]) < 0.5
    _assert_same_search(t, j, q, gt, p_tiles=6, refine_factor=32, top2=True, where=mask)
    if t._have_host() and not t._have_tier2():
        return  # the host tier serves through search() only
    if name == "int8_l2":
        _assert_same_search(t, j, q, gt, device=True, p_tiles=6, serve_from="refine")
    _assert_same_search(t, j, q, gt, device=True, p_tiles=6, refine_factor=16)


def test_aniso_encode_matches_the_reference(data, tier_builds):
    """pq_encode_aniso against the reference's on the same codebooks and
    rows (residual-like rows, the full rows as score directions): codes
    equal but at near-ties (at most 0.1%), and not the isotropic encode's."""
    db, q, gt = data
    j = tier_builds("aniso")
    x = 0.3 * db[:1000] + 0.1 * db[1000:2000]
    args = (x, db[:1000], j.codebooks)
    codes_j = np.asarray(jax_pq_encode_aniso(*(jnp.asarray(a) for a in args), eta=4.0))
    codes_t = pq_encode_aniso(*(torch.from_numpy(a) for a in args), eta=4.0, tile=256).numpy()
    assert (codes_t != codes_j).mean() <= 1e-3
    iso = pq_encode_aniso(*(torch.from_numpy(a) for a in args), eta=1.0).numpy()
    assert (iso != codes_t).mean() > 0.01


def test_cascade_parity(data):
    """'pq2+host': the reference's device-streaming pq2 build with the host
    tier attached from host copies of the chunks, against the port's; the
    cascade's shortlist at host_factor 4 and 32, and search_device's
    on-card prefix (kernel and tier 2)."""
    db, q, gt = data
    chunks = lambda i: db[i * 1000:(i + 1) * 1000]  # noqa: E731
    j = JaxPQ.build_device_streaming(lambda i: jnp.asarray(chunks(i)), 4, refine="pq2",
                                     m2=16, opq=True, train_sample=1000, **KW)
    t = BandIVFPQIndex.build_device_streaming(
        lambda i: torch.from_numpy(chunks(i)), 4, train_sample=1000, device="cpu",
        **dict(KW, **_same_quantizers(j)))
    for idx in (j, t):
        idx.attach_host_refine(chunks, 4)
        assert idx.refine == "pq2+host"
    _assert_same_arena(t, j)
    _assert_same_tiers(t, j)
    for hf in (4, 32):
        _assert_same_search(t, j, q, gt, p_tiles=6, refine_factor=32, host_factor=hf)
    _assert_same_search(t, j, q, gt, device=True, p_tiles=6, refine_factor=32)
    assert t._tune_candidates(48) == j._tune_candidates(48)
    assert t._tune_reference_kw(48) == j._tune_reference_kw(48)


@pytest.mark.parametrize("name", ["pq2_l2", "host", "int8_l2"])
def test_tier_artifacts_load_both_ways(data, l2_data, tier_builds, tmp_path, name):
    """Each tier's and l2's artifact: the reference's loads into the port
    and the port's into the reference, stores and searches alike."""
    kw, l2 = TIER_BUILDS[name]
    db, q, gt = l2_data if l2 else data
    j = tier_builds(name)
    j.save(tmp_path / "ref")
    t = load_index(tmp_path / "ref", device="cpu")
    assert t.metric == j.metric and t.refine == j.refine
    _assert_same_arena(t, j)
    _assert_same_tiers(t, j)
    _assert_same_search(t, j, q, gt, p_tiles=6, refine_factor=16)
    t.save(tmp_path / "port")
    j2 = jax_load_index(tmp_path / "port")
    _assert_same_arena(t, j2)
    _assert_same_tiers(t, j2)
    _assert_same_search(t, j2, q, gt, p_tiles=6, refine_factor=16)


@pytest.mark.parametrize("tile_n,expect", [(1024, 256), (384, 256)])
def test_skew_fit_keeps_tile_n_a_multiple_of_128(tile_n, expect):
    """1,000 one-row lists: a tile of more than 256 rows spans more lists
    than the uint8 local byte can name, so tile_n shrinks. From a power of
    two the port halves as the reference does; from 384 the reference
    lands at 192 (ADVICE.md r5), the port at 256."""
    sizes = {}
    for cls in (BandIVFPQIndex, JaxPQ):
        kw = dict(device="cpu") if cls is BandIVFPQIndex else {}
        idx = cls(64, 1000, m=8, tile_n=tile_n, **kw)
        idx._offsets = np.arange(1001, dtype=np.int64)
        idx._n = 1000
        n_pad = idx._fit_tile_n_to_skew(1000)
        assert n_pad == -(-1000 // idx.tile_n) * idx.tile_n
        assert idx._compute_tile_window().shape[1] <= 256
        sizes[cls] = idx.tile_n
    assert sizes[BandIVFPQIndex] == expect and expect % 128 == 0
    assert sizes[JaxPQ] == (expect if tile_n == 1024 else 192)
