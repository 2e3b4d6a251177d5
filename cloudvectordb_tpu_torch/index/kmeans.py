"""Lloyd's k-means (counterpart of cloudvectordb_tpu/index/kmeans.py).

Per iteration: tiled nearest-centroid assignment (ops/assign.py), centroid
update by scatter-add, and empty-cluster repair by re-seeding dead
centroids onto jittered copies of the heaviest centroid. A fixed number of
iterations, no host round trip between them.
"""

from __future__ import annotations

import torch

from cloudvectordb_tpu_torch.ops.assign import _assign_block


def _assign_tiled(x: torch.Tensor, centroids: torch.Tensor, tile: int) -> torch.Tensor:
    c_sqnorm = (centroids * centroids).sum(dim=1)
    return torch.cat([_assign_block(x[s : s + tile], centroids, c_sqnorm)[0]
                      for s in range(0, x.shape[0], tile)])


def train_kmeans(
    x: torch.Tensor,
    k: int,
    iters: int = 20,
    seed: int = 0,
    tile: int = 4096,
    init_centroids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k-means on (N, D) → (centroids (k, D) f32, assignments (N,) int64).

    Init: ``init_centroids`` when given, else k rows of a permutation drawn
    from a ``torch.Generator`` seeded with ``seed`` (when k > N the init
    cycles jittered copies of the rows). The reference draws its init from
    ``jax.random.permutation``, which torch cannot reproduce, so parity
    tests pass the same ``init_centroids`` to both packages.

    The centroid update sums with ``index_add_``. On CUDA that sums with
    atomics in an order that changes from run to run, so centroids vary in
    their last bits between runs (and so, at rounding edges, can the
    assignments that follow).
    """
    n, d = x.shape
    xf = x.float()
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    if init_centroids is not None:
        centroids = init_centroids.to(device=x.device, dtype=torch.float32).clone()
    else:
        perm = torch.randperm(n, generator=gen, device=x.device)
        if k <= n:
            centroids = xf[perm[:k]].clone()
        else:
            centroids = xf[perm[torch.arange(k, device=x.device) % n]]
            centroids += 1e-4 * torch.randn((k, d), generator=gen, device=x.device)
    for _ in range(iters):
        a = _assign_tiled(xf, centroids, tile)
        sums = torch.zeros((k, d), dtype=torch.float32, device=x.device).index_add_(0, a, xf)
        counts = torch.zeros(k, dtype=torch.float32, device=x.device).index_add_(
            0, a, torch.ones(n, dtype=torch.float32, device=x.device))
        new_c = sums / counts.clamp_min(1.0)[:, None]
        # empty-cluster repair: dead centroids become jittered copies of the
        # heaviest one (jitter from the seeded generator)
        heavy = torch.argmax(counts)
        noise = 1e-3 * torch.randn((k, d), generator=gen, device=x.device)
        respawn = new_c[heavy][None, :] + noise
        centroids = torch.where((counts > 0.0)[:, None], new_c, respawn)
    return centroids, _assign_tiled(xf, centroids, tile)
