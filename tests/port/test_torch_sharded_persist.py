"""Sharded persistence (parallel/persist.py) between the packages, and the
registry's sharded kinds: a sharded artifact the JAX package saved loads in
the port with the reference's ids; the port's save carries the reference's
manifest (keys, shard directories, extras, kw) and loads in the JAX
package with the same ids; the elastic reshard (8 -> 4 and 3 shards)
keeps every id; ``build_index(nshards=...)``, ``load_index`` and the tuned
op point round-trip; the sharded ``band_ivf_pq`` names its slice."""

import json

import numpy as np
import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.index.registry import load_index as jax_load_index
from cloudvectordb_tpu.parallel.dist_band import ShardedBandIndex as JaxShardedBandIndex
from cloudvectordb_tpu.parallel.dist_ivf import ShardedIVFPQIndex as JaxShardedIVFPQIndex
from cloudvectordb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.index.registry import build_index, load_index
from cloudvectordb_tpu_torch.parallel.dist_band import ShardedBandIndex
from cloudvectordb_tpu_torch.parallel.dist_ivf import ShardedIVFPQIndex
from cloudvectordb_tpu_torch.parallel.mesh import make_mesh
from cloudvectordb_tpu_torch.utils.config import IndexConfig

BAND_KW = dict(dtype="int8", kmeans_iters=6, tile_n=128, tile_q=16, seed=5, residual=True,
               slack=0.2)
PQ_KW = dict(nlist=16, m=8, refine="int8", kmeans_iters=6, pq_train_iters=4, seed=3)


def cpu_mesh(n: int = 8):
    return make_mesh(n, devices=["cpu"])


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4096, 64, n_clusters=32, seed=200, normalize=True)
    q = queries_from(db, 32, seed=201, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    return db, q, gt


@pytest.fixture(scope="module")
def band(data, tmp_path_factory):
    """The reference's sharded band index, searched and saved; the port's
    build from its quantizer, saved too."""
    db, q, _ = data
    out = tmp_path_factory.mktemp("band")
    j = JaxShardedBandIndex.build(db, nlist=16, mesh=jax_make_mesh(axis_name="shard"), **BAND_KW)
    n_tiles = int(j._device_state()["n_tiles"])
    ref = j.search(q, 10, p_tiles=n_tiles)
    j.save(out / "jax")
    t = ShardedBandIndex.build(db, 16, mesh=cpu_mesh(), centroids=j._shards[0].centroids,
                               **BAND_KW)
    t.save(out / "port")
    return out, ref, n_tiles


def _manifests(path):
    top = json.loads((path / "sharded.json").read_text())
    shard = json.loads((path / top["shard_dirs"][0] / "manifest.json").read_text())
    return top, shard


def test_band_artifacts_cross_both_ways(band, data):
    out, (vj, ij), n_tiles = band
    _, q, _ = data
    loaded = load_index(out / "jax", device="cpu")
    assert isinstance(loaded, ShardedBandIndex) and loaded.nshards == 8
    v, i = loaded.search(q, 10, p_tiles=n_tiles)
    np.testing.assert_array_equal(i, ij)
    np.testing.assert_allclose(v, vj, rtol=0, atol=1e-5)
    top_j, shard_j = _manifests(out / "jax")
    top_t, shard_t = _manifests(out / "port")
    assert top_t.keys() == top_j.keys() and shard_t.keys() == shard_j.keys()
    for key in ("format_version", "kind", "nshards", "shard_dirs", "extras", "kw", "op_point"):
        assert top_t[key] == top_j[key], key
    assert top_t["scale"] == pytest.approx(top_j["scale"], rel=1e-6)
    assert sorted(p.name for p in (out / "port").iterdir()) == sorted(
        p.name for p in (out / "jax").iterdir())
    back = jax_load_index(out / "port", mesh=jax_make_mesh(axis_name="shard"))
    v2, i2 = back.search(q, 10, p_tiles=n_tiles)
    np.testing.assert_array_equal(i2, ij)


def test_band_elastic_reshard(band, data):
    out, (vj, ij), _ = band
    _, q, _ = data
    for s_new in (4, 3):  # shrink, and a shard count that does not divide the rows
        t = ShardedBandIndex.load(out / "jax", mesh=cpu_mesh(s_new))
        j = JaxShardedBandIndex.load(out / "jax", mesh=jax_make_mesh(s_new, axis_name="shard"))
        assert t.nshards == s_new and t.ntotal == 4096
        v, i = t.search(q, 10, p_tiles=t._n_tiles())
        np.testing.assert_array_equal(i, ij)
        np.testing.assert_allclose(v, vj, rtol=0, atol=1e-5)
        _, ji = j.search(q, 10, p_tiles=int(j._device_state()["n_tiles"]))
        np.testing.assert_array_equal(i, ji)
    # a loaded slack arena keeps taking adds, which allocate past every id
    assert t.add(q[:4]).min() >= 4096 and t.ntotal == 4100


def test_ivfpq_artifacts_cross_and_reshard(data, tmp_path):
    db, q, gt = data
    j = JaxShardedIVFPQIndex.build(db, mesh=jax_make_mesh(axis_name="shard"), **PQ_KW)
    vj, ij = j.search(q, 10, nprobe=16)
    j.save(tmp_path / "jax")
    t = load_index(tmp_path / "jax", device="cpu")
    assert isinstance(t, ShardedIVFPQIndex) and t.refine == "int8"
    assert t._refine_scale == j._refine_scale and t.ntotal == 4096
    v, i = t.search(q, 10, nprobe=16)
    np.testing.assert_array_equal(i, ij)
    np.testing.assert_allclose(v, vj, rtol=0, atol=1e-5)
    assert recall_at_k(i, gt) >= 0.85
    t.save(tmp_path / "port")
    top_j, _ = _manifests(tmp_path / "jax")
    top_t, _ = _manifests(tmp_path / "port")
    assert top_t == top_j
    _, i2 = jax_load_index(tmp_path / "port", mesh=jax_make_mesh(axis_name="shard")).search(
        q, 10, nprobe=16)
    np.testing.assert_array_equal(i2, ij)
    r = ShardedIVFPQIndex.load(tmp_path / "port", mesh=cpu_mesh(4))
    assert r.nshards == 4 and r.ntotal == 4096
    v3, i3 = r.search(q, 10, nprobe=16)
    np.testing.assert_array_equal(i3, ij)
    np.testing.assert_allclose(v3, vj, rtol=0, atol=1e-5)
    r.add(db[:32])  # the re-split refine store and id counter keep serving adds
    assert r.ntotal == 4096 + 32 and r._next_id == 4096 + 32
    nr = ShardedIVFPQIndex.build(db[:2048], mesh=cpu_mesh(), **dict(PQ_KW, refine="none"))
    nr.save(tmp_path / "none")
    np.testing.assert_array_equal(load_index(tmp_path / "none", device="cpu").search(
        q, 5, nprobe=8)[1], nr.search(q, 5, nprobe=8)[1])


@pytest.mark.parametrize("kind", ["band_ivf", "ivf_pq"])
def test_build_index_nshards_and_tuned_op_point(data, tmp_path, kind):
    """IndexConfig(nshards=8) builds the sharded wrapper over a mesh on the
    given device; tune() sets an op point that serves by default and
    round-trips through the sharded manifest and load_index."""
    db, q, gt = data
    cfg = IndexConfig(kind=kind, nlist=16, nshards=8, residual=True, m=8, refine="int8",
                      kmeans_iters=5, pq_train_iters=4, train_sample=2048)
    idx = build_index(db, cfg, device="cpu")
    assert idx.kind == f"sharded_{kind}" and idx.nshards == 8 and idx.ntotal == 4096
    rep = idx.tune(q, k=10, target_recall=0.9, gt=gt)
    assert rep["met"], rep
    assert recall_at_k(idx.search(q, 10)[1], gt) >= 0.9
    idx.save(tmp_path / "idx", extra_meta={"config_hash": cfg.config_hash()})
    loaded = load_index(tmp_path / "idx", device="cpu")
    assert loaded._op_point == rep["op"] and loaded.nshards == 8
    np.testing.assert_array_equal(loaded.search(q, 10)[1], idx.search(q, 10)[1])
    with pytest.raises(NotImplementedError, match=r"14 \(b\)"):
        build_index(db, IndexConfig(kind="band_ivf_pq", nshards=2, m=8), device="cpu")
