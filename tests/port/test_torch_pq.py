"""PQ and OPQ training, encode and decode: the port held to the reference on
the same numpy inputs.

Training runs from the reference's own init: sub-space j of ``train_pq``
(and of each OPQ outer iteration ``it``) starts from the rows
``jax.random.permutation(PRNGKey(seed [+ it] + j))[:2**nbits]``, rebuilt
here as ``tests/port/test_torch_assign_kmeans.py`` does for k-means, on
data where no codeword empties (the reference respawns an empty codeword
with ``jax.random`` noise, which no port can match). Codebooks agree within
1e-4 after a fixed number of Lloyd iterations; the OPQ rotation within
1e-3 (U·Vᵀ does not depend on the SVD's signs, but each outer iteration
feeds the next one's data). ``pq_encode`` agrees byte for byte except at
near-ties, found explicitly as sub-vectors whose two nearest codewords lie
within 1e-5 (relative) of each other in float64 distance, and counted;
``pq_decode`` within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.data.synthetic import clustered_vectors
from cloudvectordb_tpu.index.opq import opq_reconstruction_mse as jax_opq_reconstruction_mse
from cloudvectordb_tpu.index.opq import train_opq as jax_train_opq
from cloudvectordb_tpu.index.pq import (
    pq_decode as jax_pq_decode, pq_encode as jax_pq_encode, train_pq as jax_train_pq)
from cloudvectordb_tpu_torch.index.opq import (
    init_codebooks_from_perm, opq_reconstruction_mse, train_opq)
from cloudvectordb_tpu_torch.index.pq import (
    pq_decode, pq_encode, pq_reconstruction_mse, train_pq)

M, NBITS = 8, 6


@pytest.fixture(scope="module")
def x():
    return clustered_vectors(3000, 64, n_clusters=64, seed=70)


def _perm_fn(n):
    return lambda s: np.asarray(jax.random.permutation(jax.random.PRNGKey(s), n))


def _near_ties(x, cb, rel=1e-5):
    """(N, m) bool: the two nearest codewords within ``rel`` in float64."""
    n, d = x.shape
    subs = x.astype(np.float64).reshape(n, M, d // M)
    dist = ((subs[:, :, None, :] - cb.astype(np.float64)[None]) ** 2).sum(-1)
    two = np.sort(dist, axis=2)[:, :, :2]
    return (two[:, :, 1] - two[:, :, 0]) <= rel * np.maximum(two[:, :, 1], 1e-12)


@pytest.mark.parametrize("seed", [0, 5])
def test_train_pq_from_the_reference_init(x, seed):
    cb_j = np.asarray(jax_train_pq(jnp.asarray(x), M, NBITS, iters=6, seed=seed))
    xt = torch.from_numpy(x)
    init = init_codebooks_from_perm(xt, M, NBITS, seed, _perm_fn(x.shape[0]))
    cb = train_pq(xt, M, NBITS, iters=6, seed=seed, init_codebooks=init)
    assert cb.shape == (M, 2 ** NBITS, 64 // M)
    np.testing.assert_allclose(cb.numpy(), cb_j, atol=1e-4, rtol=0)


def test_pq_encode_byte_for_byte_except_near_ties(x):
    cb = np.asarray(jax_train_pq(jnp.asarray(x), M, NBITS, iters=6, seed=1))
    codes_j = np.asarray(jax_pq_encode(jnp.asarray(x), jnp.asarray(cb)))
    codes = pq_encode(torch.from_numpy(x), torch.from_numpy(cb), tile=1024).numpy()
    assert codes.dtype == np.uint8 and codes.shape == codes_j.shape
    ties = _near_ties(x, cb)
    differ = codes != codes_j
    assert not np.any(differ & ~ties), int((differ & ~ties).sum())
    assert ties.sum() <= 10, int(ties.sum())  # near-ties are rare; counted here
    dec_j = np.asarray(jax_pq_decode(jnp.asarray(codes_j), jnp.asarray(cb)))
    dec = pq_decode(torch.from_numpy(codes_j), torch.from_numpy(cb)).numpy()
    np.testing.assert_allclose(dec, dec_j, atol=1e-6, rtol=0)
    mse = pq_reconstruction_mse(torch.from_numpy(x), torch.from_numpy(cb))
    assert mse == pytest.approx(float(np.mean(np.sum((x - dec_j) ** 2, axis=1))), rel=1e-4)


def test_train_opq_from_the_reference_init(x):
    kw = dict(outer_iters=3, pq_iters=4, seed=2)
    r_j, cb_j = jax_train_opq(x, M, NBITS, **kw)
    r, cb = train_opq(x, M, NBITS, init_perm=_perm_fn(x.shape[0]), device="cpu", **kw)
    np.testing.assert_allclose(r @ r.T, np.eye(64), atol=1e-4)
    np.testing.assert_allclose(r, r_j, atol=1e-3, rtol=0)
    np.testing.assert_allclose(cb, cb_j, atol=1e-3, rtol=0)


@pytest.mark.parametrize("eta", [4.0, 1.0])
def test_train_pq_aniso_from_the_reference_init(x, eta):
    """Anisotropic training from the reference's init (two k-means
    iterations per sub-space from the same rows, then the normal-equation
    rounds; xdir the rows themselves, x their halves): codebooks within
    1e-3; eta 1 reduces to Lloyd."""
    from cloudvectordb_tpu.index.pq import train_pq_aniso as jax_train_pq_aniso
    from cloudvectordb_tpu_torch.index.pq import train_pq_aniso

    xr = 0.5 * x
    cb_j = np.asarray(jax_train_pq_aniso(jnp.asarray(xr), jnp.asarray(x), M, NBITS, iters=4,
                                         eta=eta, seed=3))
    init = init_codebooks_from_perm(torch.from_numpy(xr), M, NBITS, 3, _perm_fn(x.shape[0]))
    cb = train_pq_aniso(torch.from_numpy(xr), torch.from_numpy(x), M, NBITS, iters=4, eta=eta,
                        seed=3, init_codebooks=init)
    assert cb.shape == cb_j.shape
    np.testing.assert_allclose(cb.numpy(), cb_j, atol=1e-3, rtol=0)


def test_opq_reconstruction_mse_matches_reference(x):
    """Rotate, PQ-encode, decode, mean summed squared error: the reference's
    rotation and codebooks on the same rows, within rtol 1e-5, as a Python
    float, from arrays and from tensors."""
    r, cb = jax_train_opq(x, M, NBITS, outer_iters=2, pq_iters=3, seed=4)
    want = jax_opq_reconstruction_mse(x, r, cb)
    got = opq_reconstruction_mse(x, r, cb)
    assert isinstance(got, float) and got == pytest.approx(want, rel=1e-5)
    assert opq_reconstruction_mse(torch.from_numpy(x), torch.tensor(r),
                                  torch.tensor(cb)) == got
