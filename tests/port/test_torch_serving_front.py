"""The tuned indexes' serving front end: how a call fills the knobs it was
not given. A knob left at its sentinel (None, or <= 0 for ``p_tiles`` and
``n_pools``) takes the tuned op point's value (``_op_point``), then the
default (nprobe 8, refine_factor 16, host_factor 64, serve_from 'pq', top2
False); an explicit argument beats the op point; a batch smaller than the
index's query tile, given no ``tile_q``, is served at a tile of
max(8, next_pow2(nq)) by the kinds that shrink it; and the tiles kinds'
tune ladders equal the JAX package's, built on the same rows and
quantizers, and fixed lists, in order. Every kind is a tiny CPU index with
a hand-set op point; answers are compared exactly."""

import numpy as np
import pytest
import torch

from cloudvectordb_tpu.index.ivf_band import BandIVFIndex as JaxBandIVFIndex
from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex as JaxBandIVFPQIndex
from cloudvectordb_tpu.parallel.dist_band import ShardedBandIndex as JaxShardedBandIndex
from cloudvectordb_tpu.parallel.dist_band_pq import ShardedBandIVFPQIndex as JaxShardedPQ
from cloudvectordb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cloudvectordb_tpu_torch.index import ivf_band, ivf_band_pq
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex
from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex
from cloudvectordb_tpu_torch.index.ivf_flat import IVFFlatIndex
from cloudvectordb_tpu_torch.index.ivf_pq import IVFPQIndex
from cloudvectordb_tpu_torch.parallel import dist_band_pq
from cloudvectordb_tpu_torch.parallel.dist_band import ShardedBandIndex
from cloudvectordb_tpu_torch.parallel.dist_band_pq import ShardedBandIVFPQIndex
from cloudvectordb_tpu_torch.parallel.dist_ivf import ShardedIVFPQIndex
from cloudvectordb_tpu_torch.parallel.mesh import make_mesh

D, K, N = 32, 5, 8000
NQ = 40  # at or past every kind's query tile: no shrink


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tiny CPU shapes gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def db():
    return np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)


TILES = dict(kmeans_iters=3, tile_n=128, tile_q=16)
PQ = dict(m=8, nbits=5, pq_train_iters=3)

#: kind -> (its build, the hand-set op point, explicit knobs unlike it, the
#: defaults table's knobs the kind takes)
KINDS = {
    "resid": (
        lambda db: BandIVFIndex.build(db, nlist=16, residual=True, device="cpu", **TILES),
        {"p_tiles": 6, "tile_q": 32, "top2": True},
        {"p_tiles": 3, "tile_q": 16, "top2": False},
        {"top2": False}),
    "pq": (
        lambda db: BandIVFPQIndex.build(db, nlist=16, refine="int8", opq=True, device="cpu",
                                        **TILES, **PQ),
        {"p_tiles": 6, "tile_q": 32, "serve_from": "pq", "refine_factor": 8, "n_pools": 2,
         "top2": True},
        {"p_tiles": 3, "tile_q": 16, "serve_from": "refine", "refine_factor": 4,
         "n_pools": 1, "top2": False},
        {"serve_from": "pq", "refine_factor": 16, "top2": False}),
    "sharded_band": (
        lambda db: ShardedBandIndex.build(db, 16, mesh=make_mesh(2, devices=["cpu"]),
                                          residual=True, **TILES),
        {"p_tiles": 6, "top2": True},
        {"p_tiles": 3, "top2": False},
        {"top2": False}),
    "sharded_pq": (
        lambda db: ShardedBandIVFPQIndex.build(db, 16, mesh=make_mesh(2, devices=["cpu"]),
                                               refine="int8", **TILES, **PQ),
        {"p_tiles": 6, "tile_q": 32, "refine_factor": 8, "n_pools": 2, "top2": True,
         "host_factor": 32},
        {"p_tiles": 3, "tile_q": 16, "refine_factor": 4, "n_pools": 1, "top2": False,
         "host_factor": 16},
        {"refine_factor": 16, "host_factor": 64, "top2": False}),
    "ivf_pq": (
        lambda db: IVFPQIndex.build(db, 16, refine="int8", kmeans_iters=3, device="cpu", **PQ),
        {"nprobe": 4, "refine_factor": 8},
        {"nprobe": 2, "refine_factor": 4},
        {"nprobe": 8, "refine_factor": 16}),
    "ivf_flat": (
        lambda db: IVFFlatIndex.build(db, 16, kmeans_iters=3, device="cpu"),
        {"nprobe": 4},
        {"nprobe": 2},
        {"nprobe": 8}),
    "sharded_ivf_pq": (
        lambda db: ShardedIVFPQIndex.build(db, 16, mesh=make_mesh(2, devices=["cpu"]),
                                           refine="int8", kmeans_iters=3, **PQ),
        {"nprobe": 4, "refine_factor": 8},
        {"nprobe": 2, "refine_factor": 4},
        {"nprobe": 8, "refine_factor": 16}),
}
#: (kind, method): the kinds with an all-device twin are held through it too
CALLS = [(kind, "search") for kind in KINDS] + [
    (kind, "search_device") for kind in ("resid", "pq", "sharded_band")]


@pytest.fixture(scope="module")
def _indexes():
    return {}


@pytest.fixture
def built(db, _indexes):
    """kind -> its index (built once a module), the op point cleared."""
    def get(kind):
        if kind not in _indexes:
            _indexes[kind] = KINDS[kind][0](db)
        idx = _indexes[kind]
        idx._op_point = None
        return idx
    yield get
    for idx in _indexes.values():
        idx._op_point = None


def answers(idx, method, q, **kw):
    """(scores, ids) as numpy, whichever way the call goes in and out."""
    if method == "search":
        return idx.search(q, K, **kw)
    v, i = idx.search_device(torch.as_tensor(q), K, **kw)
    return v.cpu().numpy(), i.cpu().numpy()


def assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("kind,method", CALLS)
def test_sentinels_take_the_op_point(db, built, kind, method):
    idx, (_, op, other, _) = built(kind), KINDS[kind]
    q = db[:NQ]
    explicit = answers(idx, method, q, **op)
    assert not np.array_equal(explicit[1], answers(idx, method, q, **other)[1])
    idx._op_point = dict(op)
    assert_same(answers(idx, method, q), explicit)


@pytest.mark.parametrize("kind,method", CALLS)
def test_an_explicit_argument_beats_the_op_point(db, built, kind, method):
    idx, (_, op, other, _) = built(kind), KINDS[kind]
    q = db[:NQ]
    want = answers(idx, method, q, **other)
    idx._op_point = dict(op)
    assert_same(answers(idx, method, q, **other), want)


@pytest.mark.parametrize("kind,method", CALLS)
def test_without_an_op_point_the_defaults_apply(db, built, kind, method):
    idx, defaults = built(kind), KINDS[kind][3]
    q = db[:NQ]
    assert_same(answers(idx, method, q), answers(idx, method, q, **defaults))


def _spy_tile_q(monkeypatch, kind) -> list:
    """The query tile each scan of ``kind`` was planned at."""
    mod, name = {"resid": (ivf_band, "_tiles_resid_plan_search"),
                 "sharded_band": (ivf_band, "_tiles_resid_plan_search"),
                 "pq": (ivf_band_pq, "_pq_tiles_plan_search"),
                 "sharded_pq": (dist_band_pq, "_pq_tiles_core")}[kind]
    real, seen = getattr(mod, name), []

    def spy(*a, **kw):
        seen.append(kw["tile_q"])
        return real(*a, **kw)

    monkeypatch.setattr(mod, name, spy)
    return seen


@pytest.mark.parametrize("nq", [1, 5, 64])
@pytest.mark.parametrize("kind,method", [c for c in CALLS
                                         if c[0] in ("resid", "pq", "sharded_pq")])
def test_a_small_batch_takes_the_pow2_query_tile(db, built, monkeypatch, kind, method, nq):
    idx = built(kind)
    proto = idx.proto if kind == "sharded_pq" else idx
    proto.tile_q, before = 128, proto.tile_q  # a tile past every batch here
    try:
        seen = _spy_tile_q(monkeypatch, kind)
        q = db[100:100 + nq]
        tq = max(8, 1 << (nq - 1).bit_length())
        assert_same(answers(idx, method, q), answers(idx, method, q, tile_q=tq))
        assert seen and set(seen) == {tq}
    finally:
        proto.tile_q = before


@pytest.mark.parametrize("method", ["search", "search_device"])
def test_the_sharded_band_index_keeps_its_query_tile(db, built, monkeypatch, method):
    idx = built("sharded_band")
    seen = _spy_tile_q(monkeypatch, "sharded_band")
    answers(idx, method, db[:5])
    assert seen and set(seen) == {TILES["tile_q"]}


#: each tiles kind's tune ladder over 40,000 rows in 256 lists at nq 64 and
#: 4096, fixed so that any change to a ladder shows: (the keys, a row of
#: values a candidate, None for a key the candidate lacks), in order
LADDERS = {
    ('resid', 64): ('p_tiles tile_q', [
        (96, 16), (160, 16), (192, 32), (288, 64), (288, 32), (288, 16), (313, 64), (313, 32),
        (313, 16)]),
    ('resid', 4096): ('p_tiles tile_q', [
        (32, 128), (32, 64), (32, 32), (32, 16), (64, 128), (64, 64), (96, 128), (96, 64),
        (96, 32), (96, 16), (160, 64), (160, 32), (160, 16), (192, 128), (256, 16), (288, 64),
        (288, 32), (313, 128), (313, 64), (313, 32), (313, 16)]),
    ('pq', 64): ('p_tiles tile_q serve_from', [
        (96, 16, 'refine'), (160, 16, 'refine'), (192, 32, 'refine'), (288, 64, 'refine'),
        (288, 32, 'refine'), (288, 16, 'refine'), (313, 64, 'refine'), (313, 32, 'refine'),
        (313, 16, 'refine')]),
    ('pq', 4096): ('p_tiles tile_q serve_from', [
        (32, 128, 'refine'), (32, 64, 'refine'), (32, 32, 'refine'), (32, 16, 'refine'),
        (64, 128, 'refine'), (64, 64, 'refine'), (96, 128, 'refine'), (96, 64, 'refine'),
        (96, 32, 'refine'), (96, 16, 'refine'), (160, 64, 'refine'), (160, 32, 'refine'),
        (160, 16, 'refine'), (192, 128, 'refine'), (256, 16, 'refine'), (288, 64, 'refine'),
        (288, 32, 'refine'), (313, 128, 'refine'), (313, 64, 'refine'), (313, 32, 'refine'),
        (313, 16, 'refine')]),
    ('pq_pqroute', 64): ('p_tiles tile_q refine_factor top2', [
        (96, 16, 16, None), (96, 16, 64, None), (96, 16, 64, True), (96, 16, 102, None),
        (96, 16, 102, True), (160, 16, 16, None), (160, 16, 64, None), (192, 32, 16, None),
        (160, 16, 64, True), (160, 16, 102, None), (160, 16, 102, True), (192, 32, 64, None),
        (192, 32, 64, True), (192, 32, 102, None), (192, 32, 102, True), (288, 64, 16, None),
        (288, 32, 16, None), (288, 16, 16, None), (313, 64, 16, None), (313, 32, 16, None),
        (313, 16, 16, None), (288, 64, 64, None), (288, 32, 64, None), (288, 16, 64, None),
        (288, 64, 64, True), (288, 32, 64, True), (288, 16, 64, True), (313, 64, 64, None),
        (313, 32, 64, None), (313, 16, 64, None), (313, 64, 64, True), (313, 32, 64, True),
        (313, 16, 64, True), (288, 64, 102, None), (288, 32, 102, None), (288, 16, 102, None),
        (288, 64, 102, True), (288, 32, 102, True), (288, 16, 102, True), (313, 64, 102, None),
        (313, 32, 102, None), (313, 16, 102, None), (313, 64, 102, True), (313, 32, 102, True),
        (313, 16, 102, True)]),
    ('pq_pqroute', 4096): ('p_tiles tile_q refine_factor top2', [
        (32, 128, 16, None), (32, 64, 16, None), (32, 32, 16, None), (32, 16, 16, None),
        (32, 128, 64, None), (32, 64, 64, None), (32, 32, 64, None), (32, 16, 64, None),
        (32, 128, 64, True), (32, 64, 64, True), (32, 32, 64, True), (32, 16, 64, True),
        (32, 128, 102, None), (32, 64, 102, None), (32, 32, 102, None), (32, 16, 102, None),
        (32, 128, 102, True), (32, 64, 102, True), (32, 32, 102, True), (32, 16, 102, True),
        (64, 128, 16, None), (64, 64, 16, None), (64, 128, 64, None), (64, 64, 64, None),
        (64, 128, 64, True), (64, 64, 64, True), (64, 128, 102, None), (64, 64, 102, None),
        (64, 128, 102, True), (64, 64, 102, True), (96, 128, 16, None), (96, 64, 16, None),
        (96, 32, 16, None), (96, 16, 16, None), (96, 128, 64, None), (96, 64, 64, None),
        (96, 32, 64, None), (96, 16, 64, None), (96, 128, 64, True), (96, 64, 64, True),
        (96, 32, 64, True), (96, 16, 64, True), (96, 128, 102, None), (96, 64, 102, None),
        (96, 32, 102, None), (96, 16, 102, None), (96, 128, 102, True), (96, 64, 102, True),
        (96, 32, 102, True), (96, 16, 102, True), (160, 64, 16, None), (160, 32, 16, None),
        (160, 16, 16, None), (160, 64, 64, None), (160, 32, 64, None), (160, 16, 64, None),
        (192, 128, 16, None), (160, 64, 64, True), (160, 32, 64, True), (160, 16, 64, True),
        (160, 64, 102, None), (160, 32, 102, None), (160, 16, 102, None), (160, 64, 102, True),
        (160, 32, 102, True), (160, 16, 102, True), (192, 128, 64, None), (192, 128, 64, True),
        (192, 128, 102, None), (256, 16, 16, None), (192, 128, 102, True), (288, 64, 16, None),
        (288, 32, 16, None), (256, 16, 64, None), (256, 16, 64, True), (313, 128, 16, None),
        (313, 64, 16, None), (313, 32, 16, None), (313, 16, 16, None), (256, 16, 102, None),
        (288, 64, 64, None), (288, 32, 64, None), (256, 16, 102, True), (288, 64, 64, True),
        (288, 32, 64, True), (313, 128, 64, None), (313, 64, 64, None), (313, 32, 64, None),
        (313, 16, 64, None), (313, 128, 64, True), (313, 64, 64, True), (313, 32, 64, True),
        (313, 16, 64, True), (288, 64, 102, None), (288, 32, 102, None), (288, 64, 102, True),
        (288, 32, 102, True), (313, 128, 102, None), (313, 64, 102, None),
        (313, 32, 102, None), (313, 16, 102, None), (313, 128, 102, True),
        (313, 64, 102, True), (313, 32, 102, True), (313, 16, 102, True)]),
    ('sharded_band', 64): ('p_tiles', [
        (32,), (64,), (128,), (157,)]),
    ('sharded_band', 4096): ('p_tiles', [
        (32,), (32,), (32,), (64,), (128,), (157,)]),
    ('sharded_pq', 64): ('p_tiles refine_factor top2', [
        (32, 16, None), (32, 64, None), (32, 64, True), (32, 102, None), (32, 102, True),
        (64, 16, None), (64, 64, None), (64, 64, True), (64, 102, None), (64, 102, True),
        (128, 16, None), (128, 64, None), (128, 64, True), (157, 16, None), (128, 102, None),
        (128, 102, True), (157, 64, None), (157, 64, True), (157, 102, None), (157, 102, True)]),
    ('sharded_pq', 4096): ('p_tiles refine_factor top2', [
        (32, 16, None), (32, 64, None), (32, 64, True), (32, 102, None), (32, 102, True),
        (64, 16, None), (64, 64, None), (64, 64, True), (64, 102, None), (64, 102, True),
        (128, 16, None), (128, 64, None), (128, 64, True), (157, 16, None), (128, 102, None),
        (128, 102, True), (157, 64, None), (157, 64, True), (157, 102, None), (157, 102, True)]),
}
LADDER_BUILDS = {
    "resid": lambda db: BandIVFIndex.build(db, nlist=256, residual=True, device="cpu",
                                           **TILES),
    "pq": lambda db: BandIVFPQIndex.build(db, nlist=256, refine="int8", opq=True, device="cpu",
                                          **TILES, **PQ),
    # whole-row int8 refine rows: the PQ route's ladder (refine depth x top-2)
    "pq_pqroute": lambda db: BandIVFPQIndex.build(db, nlist=256, refine="int8", residual=False,
                                                  device="cpu", **TILES, **PQ),
    "sharded_band": lambda db: ShardedBandIndex.build(
        db, 256, mesh=make_mesh(2, devices=["cpu"]), residual=True, **TILES),
    "sharded_pq": lambda db: ShardedBandIVFPQIndex.build(
        db, 256, mesh=make_mesh(2, devices=["cpu"]), refine="int8", **TILES, **PQ),
}


@pytest.fixture(scope="module")
def ladder_db():
    return np.random.default_rng(0).normal(size=(40_000, D)).astype(np.float32)


@pytest.mark.parametrize("kind", list(LADDER_BUILDS))
def test_tune_candidates_are_the_fixed_ladders(ladder_db, kind):
    idx = LADDER_BUILDS[kind](ladder_db)
    for nq in (64, 4096):
        keys, rows = LADDERS[(kind, nq)]
        want = [{k: v for k, v in zip(keys.split(), row) if v is not None} for row in rows]
        assert idx._tune_candidates(nq) == want, nq


def _pq_quantizers(j) -> dict:
    return dict(centroids=np.asarray(j.centroids), codebooks=np.asarray(j.codebooks),
                codebooks2=None if j.codebooks2 is None else np.asarray(j.codebooks2))


#: kind -> (the JAX package's build, the port's on its quantizers), the
#: shapes of LADDER_BUILDS
TWIN_BUILDS = {
    "resid": (
        lambda db: JaxBandIVFIndex.build(db, nlist=256, residual=True, **TILES),
        lambda db, j: BandIVFIndex.build(db, nlist=256, residual=True, device="cpu",
                                         centroids=j.centroids, **TILES)),
    "pq": (
        lambda db: JaxBandIVFPQIndex.build(db, nlist=256, refine="int8", opq=True, **TILES, **PQ),
        lambda db, j: BandIVFPQIndex.build(db, nlist=256, refine="int8", opq=True, device="cpu",
                                           opq_matrix=j.opq_matrix, **TILES,
                                           **{**PQ, **_pq_quantizers(j)})),
    "pq_pqroute": (
        lambda db: JaxBandIVFPQIndex.build(db, nlist=256, refine="int8", residual=False,
                                           **TILES, **PQ),
        lambda db, j: BandIVFPQIndex.build(db, nlist=256, refine="int8", residual=False,
                                           device="cpu", **TILES,
                                           **{**PQ, **_pq_quantizers(j)})),
    "sharded_band": (
        lambda db: JaxShardedBandIndex.build(db, 256, mesh=jax_make_mesh(2, axis_name="shard"),
                                             residual=True, **TILES),
        lambda db, j: ShardedBandIndex.build(db, 256, mesh=make_mesh(2, devices=["cpu"]),
                                             residual=True, centroids=j._shards[0].centroids,
                                             **TILES)),
    "sharded_pq": (
        lambda db: JaxShardedPQ.build(db, 256, mesh=jax_make_mesh(2, axis_name="shard"),
                                      refine="int8", **TILES, **PQ),
        lambda db, j: ShardedBandIVFPQIndex.build(db, 256, mesh=make_mesh(2, devices=["cpu"]),
                                                  refine="int8", **TILES,
                                                  **{**PQ, **_pq_quantizers(j.proto)})),
}


@pytest.mark.parametrize("kind", list(TWIN_BUILDS))
def test_tune_candidates_equal_the_references(ladder_db, kind):
    jax_build, port_build = TWIN_BUILDS[kind]
    j = jax_build(ladder_db)
    t = port_build(ladder_db, j)
    for nq in (64, 4096):
        assert t._tune_candidates(nq) == j._tune_candidates(nq), nq
