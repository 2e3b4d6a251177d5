"""Coarse quantizer: assign_clusters and train_kmeans, port against reference
on the same numpy inputs.

Tolerances: assignments >= 99.9% equal (f32 distances summed in another
order can flip a near-tie), squared distances within 1e-4; k-means
centroids within 1e-4 after a fixed number of Lloyd iterations from the same
init on data where no cluster empties."""

import jax
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors
from cloudvectordb_tpu.index.kmeans import train_kmeans as jax_train_kmeans
from cloudvectordb_tpu.ops.assign import assign_clusters as jax_assign_clusters
from cloudvectordb_tpu_torch.index.kmeans import train_kmeans
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
