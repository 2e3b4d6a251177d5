"""Coarse quantizer: assign_clusters and train_kmeans, port against reference
on the same numpy inputs.

Tolerances: assignments >= 99.9% equal (f32 distances summed in another
order can flip a near-tie), squared distances within 1e-4; k-means
centroids within 1e-4 after a fixed number of Lloyd iterations from the same
init on data where no cluster empties. The fixed-order segment sum of the
centroid update within 2e-6 relative of a float64 sum (f32 rounding of a
pairwise tree over at most a few thousand rows)."""

import jax
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors
from cloudvectordb_tpu.index.kmeans import kmeans_objective as jax_kmeans_objective
from cloudvectordb_tpu.index.kmeans import train_kmeans as jax_train_kmeans
from cloudvectordb_tpu.ops.assign import assign_clusters as jax_assign_clusters
from cloudvectordb_tpu_torch.index.kmeans import _segment_sums, kmeans_objective, train_kmeans
from cloudvectordb_tpu_torch.ops.assign import assign_clusters


@pytest.mark.parametrize("tile", [1024, 8192])
def test_assign_clusters_matches_reference(tile):
    x = clustered_vectors(5000, 32, n_clusters=16, seed=11)
    c = np.random.default_rng(12).normal(size=(64, 32)).astype(np.float32)
    a_j, d_j = (np.asarray(v) for v in jax_assign_clusters(x, c, tile=tile))
    a, d = assign_clusters(torch.from_numpy(x), torch.from_numpy(c), tile=tile)
    assert (a.numpy() == a_j).mean() >= 0.999
    np.testing.assert_allclose(d.numpy(), d_j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("seed", [0, 3])
def test_train_kmeans_from_the_reference_init(seed):
    x = clustered_vectors(3000, 24, n_clusters=8, seed=21 + seed, normalize=True)
    k = 8
    c_j, a_j = (np.asarray(v) for v in jax_train_kmeans(x, k, iters=8, seed=seed))
    assert np.bincount(a_j, minlength=k).min() > 0  # no cluster emptied
    # the reference's init: the first k rows of jax.random.permutation
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), x.shape[0]))
    c, a = train_kmeans(torch.from_numpy(x), k, iters=8, seed=seed,
                        init_centroids=torch.from_numpy(x[perm[:k]]))
    np.testing.assert_allclose(c.numpy(), c_j, atol=1e-4, rtol=0)
    assert (a.numpy() == a_j).mean() >= 0.999


def test_train_kmeans_own_init_is_seeded_and_repairs_empties():
    """Without an init the port draws one from a seeded torch.Generator:
    the same seed gives the same centroids. k > N cycles jittered rows and
    the respawn keeps every centroid finite."""
    x = torch.from_numpy(clustered_vectors(500, 16, n_clusters=4, seed=31))
    c1, a1 = train_kmeans(x, 16, iters=5, seed=7)
    c2, a2 = train_kmeans(x, 16, iters=5, seed=7)
    torch.testing.assert_close(c1, c2, rtol=0, atol=0)
    assert torch.equal(a1, a2) and a1.max() < 16
    tiny = x[:10]
    c3, a3 = train_kmeans(tiny, 32, iters=3, seed=0)
    assert c3.shape == (32, 16) and torch.isfinite(c3).all()
    assert a3.shape == (10,)


@pytest.mark.parametrize("k", [1, 7, 300])
def test_segment_sums_match_a_float64_sum(k):
    """The centroid update's sums, in a fixed order: skewed segment sizes
    (one segment holds half the rows), empty segments, ragged spans."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(5000, 24)).astype(np.float32)
    a = np.where(rng.random(5000) < 0.5, 0, rng.integers(0, k, 5000)) % max(k - 1, 1)
    sums, counts = _segment_sums(torch.from_numpy(x), torch.from_numpy(a), k)
    ref = np.zeros((k, 24), np.float64)
    np.add.at(ref, a, x.astype(np.float64))
    np.testing.assert_array_equal(counts.numpy(), np.bincount(a, minlength=k))
    np.testing.assert_allclose(sums.numpy(), ref, rtol=2e-6, atol=2e-5)
    again, _ = _segment_sums(torch.from_numpy(x), torch.from_numpy(a), k)
    assert torch.equal(again, sums)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_kmeans_objective_matches_reference(dtype):
    """The mean squared distance to the assigned centroid, from the same
    rows, centroids and assignments (rows of another type are widened to
    f32 first), within rtol 1e-5."""
    rng = np.random.default_rng(41)
    x = clustered_vectors(2000, 16, n_clusters=8, seed=40).astype(dtype)
    c = rng.normal(size=(8, 16)).astype(np.float32)
    a = rng.integers(0, 8, size=2000).astype(np.int32)
    want = float(jax_kmeans_objective(jax.numpy.asarray(x), jax.numpy.asarray(c),
                                      jax.numpy.asarray(a)))
    got = kmeans_objective(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(a))
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == pytest.approx(want, rel=1e-5)
