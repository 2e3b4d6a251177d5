"""index/registry.py::build_index against the JAX package's on the same
seeded vectors and IndexConfig, for every single-card kind: kind, ntotal,
dim and metric equal; flat's ids equal; recall@10 against the exact top-10
with every list probed at least the reference's less RECALL_MARGIN (the
quantizers differ: each package trains its own from its own random stream,
and jax.random's cannot be reproduced in torch); the port's saved artifact
loads in both packages' load_index and serves the same answers in the
port; a sharded config builds the sharded wrapper (parallel/), but for
band_ivf_pq's, which raises and names its part of the distribution item."""

import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.index.registry import build_index as jax_build_index
from cloudvectordb_tpu.index.registry import load_index as jax_load_index
from cloudvectordb_tpu.utils.config import IndexConfig as JaxIndexConfig
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu_torch.index.registry import build_index, load_index
from cloudvectordb_tpu_torch.utils.config import IndexConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch here: the tiny CPU shapes gain nothing
    from more, and under several test workers on one machine the extra
    threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


#: the port's recall may trail the reference's by this much (quantizers
#: trained from different random streams on 3,000 rows)
RECALL_MARGIN = 0.02
NLIST = 16

KINDS = {
    "flat": dict(kind="flat"),
    "ivf_flat": dict(kind="ivf_flat"),
    "ivf_pq": dict(kind="ivf_pq", m=8, nbits=6),
    "ivf_pq_opq": dict(kind="ivf_pq", m=8, nbits=6, opq=True),
    "band_ivf_resid": dict(kind="band_ivf", dtype="int8"),
    "band_ivf_whole": dict(kind="band_ivf", dtype="int8", residual=False),
    "band_ivf_pq": dict(kind="band_ivf_pq", m=8, nbits=6),
}


@pytest.fixture(scope="module")
def data():
    x = clustered_vectors(3000, 64, n_clusters=24, seed=0, normalize=True, latent_dim=16)
    q = queries_from(x, 64, seed=1, normalize=True)
    _, gt = brute_force_topk(x, q, 10)
    return x, q, gt


@pytest.mark.parametrize("name", list(KINDS))
def test_build_index_matches_the_reference(data, tmp_path, name):
    x, q, gt = data
    kw = dict(nlist=NLIST, kmeans_iters=5, pq_train_iters=4, train_sample=4096, **KINDS[name])
    idx = build_index(x, IndexConfig(**kw), device="cpu")
    ref = jax_build_index(x, JaxIndexConfig(**kw))
    assert (idx.kind, idx.ntotal, idx.dim, idx.metric) == (
        ref.kind, ref.ntotal, ref.dim, ref.metric)
    skw = {} if idx.kind == "flat" else {"nprobe": NLIST}
    _, found = idx.search(q, 10, **skw)
    _, ref_found = ref.search(q, 10, **skw)
    ref_found = np.asarray(ref_found)
    if idx.kind == "flat":
        np.testing.assert_array_equal(found, ref_found)
    assert recall_at_k(found, gt) >= recall_at_k(ref_found, gt) - RECALL_MARGIN
    assert recall_at_k(found, gt) >= 0.9

    idx.save(tmp_path / "idx")
    back = load_index(tmp_path / "idx", device="cpu")
    np.testing.assert_array_equal(back.search(q, 10, **skw)[1], found)
    jback = jax_load_index(tmp_path / "idx")
    assert (jback.kind, jback.ntotal, jback.dim) == (idx.kind, idx.ntotal, idx.dim)
    assert recall_at_k(np.asarray(jback.search(q, 10, **skw)[1]), gt) >= 0.9


def test_build_index_clamps_nlist_and_maps_band_dtypes(data):
    """nlist = min(cfg.nlist, N // 4); band_ivf: a 'float32' dtype means
    int8, residual only with int8, slack only with residual."""
    x, _, _ = data
    small = x[:40]
    idx = build_index(small, IndexConfig(kind="ivf_flat", nlist=64, kmeans_iters=2),
                      device="cpu")
    assert idx.nlist == 10
    band = build_index(x, IndexConfig(kind="band_ivf", nlist=NLIST, kmeans_iters=2,
                                      dtype="float32", slack=0.1), device="cpu")
    assert (band.dtype, band.residual, band.slack) == ("int8", True, 0.1)
    whole = build_index(x, IndexConfig(kind="band_ivf", nlist=NLIST, kmeans_iters=2,
                                       dtype="bfloat16", slack=0.1), device="cpu")
    assert (whole.dtype, whole.residual, whole.slack) == ("bfloat16", False, 0.0)
    with pytest.raises(ValueError):
        build_index(x, IndexConfig(kind="hnsw"), device="cpu")


@pytest.mark.parametrize("kind", ["band_ivf", "ivf_pq"])
def test_sharded_config_raises_and_names_distribution(data, kind):
    """Since the distribution slice ported sharded serving, nshards > 0
    builds band_ivf and ivf_pq sharded over a mesh on the given device, and
    since config #5 across shards, band_ivf_pq too; another kind raises,
    naming the kinds it supports."""
    x = data[0]
    idx = build_index(x, IndexConfig(kind=kind, nshards=2, nlist=16, m=8), device="cpu")
    assert idx.kind == f"sharded_{kind}" and idx.nshards == 2 and idx.ntotal == x.shape[0]
    assert all(sh.device == torch.device("cpu") for sh in idx._shards)
    pq = build_index(x, IndexConfig(kind="band_ivf_pq", nshards=2, nlist=16, m=8,
                                    refine="pq2", kmeans_iters=2, pq_train_iters=2),
                     device="cpu")
    assert pq.kind == "sharded_band_ivf_pq" and pq.nshards == 2 and pq.ntotal == x.shape[0]
    assert all(sh.device == torch.device("cpu") for sh in pq._shards)
    with pytest.raises(ValueError, match="band_ivf_pq"):
        build_index(x, IndexConfig(kind="ivf_flat", nshards=2), device="cpu")
