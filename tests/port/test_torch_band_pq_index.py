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
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.eval import tune as jax_tune
from cloudvectordb_tpu.index import load_index as jax_load_index
from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex as JaxPQ
from cloudvectordb_tpu_torch.eval import tune
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex
from cloudvectordb_tpu_torch.index.registry import load_index

KW = dict(nlist=16, m=8, nbits=6, kmeans_iters=6, pq_train_iters=6, tile_n=256, tile_q=16)
#: (refine, residual): residual-int8 refine, whole-row int8 refine, no refine
BUILDS = {"resid_int8": ("int8", True), "whole_int8": ("int8", False),
          "resid_none": ("none", True)}


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


def _same_quantizers(j) -> dict:
    return dict(centroids=j.centroids, codebooks=j.codebooks, opq_matrix=j.opq_matrix,
                refine=j.refine, residual=j.residual)


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
    for bad in (dict(refine="pq2"), dict(refine="host"), dict(refine="pq2+host"),
                dict(metric="l2"), dict(aniso_eta=4.0)):
        with pytest.raises(NotImplementedError):
            BandIVFPQIndex(64, 16, m=8, device="cpu", **bad)
    with pytest.raises(ValueError):
        BandIVFPQIndex(64, 16, m=8, refine="int4", device="cpu")
    j = jax_builds("resid_none")
    t = BandIVFPQIndex.build(data[0], device="cpu", **dict(KW, **_same_quantizers(j)))
    for call in (lambda: t.add(data[0][:4]), lambda: t.remove([1]), t.merge_pending,
                 lambda: t.merge_from(t), lambda: t.attach_host_refine(None, 1),
                 lambda: t.search(data[1], 10, where={"tenant": 1})):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(ValueError):  # no refine rows to scan
        t.search(data[1], 10, serve_from="refine")


def test_filters_and_l2_still_refused(data, jax_builds, tmp_path):
    """BandIVFIndex's where=, top2-free l2 and their caches do not leak into
    the PQ subclass: where= (search and search_device) and metric='l2' (the
    constructor and a saved l2 manifest) raise, naming item 13."""
    j = jax_builds("resid_int8")
    t = BandIVFPQIndex.build(data[0], device="cpu", **dict(KW, **_same_quantizers(j)))
    mask = np.ones(data[0].shape[0], bool)
    for call in (lambda: t.search(data[1], 10, where=mask),
                 lambda: t.search_device(torch.from_numpy(data[1]), 10, where=mask),
                 lambda: t.search(data[1], 10, where=mask, serve_from="refine"),
                 lambda: BandIVFPQIndex(64, 16, m=8, metric="l2", device="cpu")):
        with pytest.raises(NotImplementedError, match="item 13"):
            call()
    t.save(tmp_path / "pq")
    manifest = json.loads((tmp_path / "pq" / "manifest.json").read_text())
    (tmp_path / "pq" / "manifest.json").write_text(json.dumps(dict(manifest, metric="l2")))
    with pytest.raises(NotImplementedError, match="item 13"):
        load_index(tmp_path / "pq", device="cpu")
    # its refine route still takes K1's unfiltered ip top-1 variant
    v, ids = t.search(data[1], 10, serve_from="refine", p_tiles=4)
    assert np.isfinite(v).all() and (ids >= 0).all()


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
