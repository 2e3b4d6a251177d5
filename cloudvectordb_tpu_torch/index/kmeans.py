"""Lloyd's k-means (counterpart of cloudvectordb_tpu/index/kmeans.py).

Per iteration: tiled nearest-centroid assignment (ops/assign.py), centroid
update by a segment sum in a fixed order, and empty-cluster repair by
re-seeding dead centroids onto jittered copies of the heaviest centroid. A
fixed number of iterations.
"""

from __future__ import annotations

import torch

from cloudvectordb_tpu_torch.ops.assign import _assign_block


def _assign_tiled(x: torch.Tensor, centroids: torch.Tensor, tile: int) -> torch.Tensor:
    c_sqnorm = (centroids * centroids).sum(dim=1)
    return torch.cat([_assign_block(x[s : s + tile], centroids, c_sqnorm)[0]
                      for s in range(0, x.shape[0], tile)])


def _segment_sums(x: torch.Tensor, a: torch.Tensor, k: int):
    """(k, D) f32 sums of the rows of ``x`` per assignment, and (k,) f32
    counts, in an order fixed by the data alone (the reference's
    ``segment_sum``; ``index_add_`` on CUDA adds with atomics in an order
    that changes between runs).

    Rows are stably sorted by assignment, then a segmented Hillis-Steele
    scan doubles its span until it covers the longest segment: at span s,
    row i adds row i-s when both lie in one segment. Each step is
    elementwise, so every sum is the same pairwise tree on every run. The
    last row of each segment then holds its sum. Integer counts
    (``bincount``) are exact in any order.
    """
    order = torch.argsort(a, stable=True)
    seg = a[order]
    v = x[order]
    counts = torch.bincount(a, minlength=k)
    span, longest = 1, int(counts.max())
    while span < longest:
        same = (seg[span:] == seg[:-span])[:, None]
        v = torch.cat([v[:span], v[span:] + torch.where(same, v[:-span], 0.0)])
        span *= 2
    last = (torch.cumsum(counts, 0) - 1).clamp_min(0)
    sums = torch.where((counts > 0)[:, None], v[last], 0.0)
    return sums, counts.float()


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

    The centroid update is ``_segment_sums``: the same input gives
    bit-identical centroids on every run, on the CPU and on CUDA, with no
    global determinism switch.
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
        sums, counts = _segment_sums(xf, a, k)
        new_c = sums / counts.clamp_min(1.0)[:, None]
        # empty-cluster repair: dead centroids become jittered copies of the
        # heaviest one (jitter from the seeded generator)
        heavy = torch.argmax(counts)
        noise = 1e-3 * torch.randn((k, d), generator=gen, device=x.device)
        respawn = new_c[heavy][None, :] + noise
        centroids = torch.where((counts > 0.0)[:, None], new_c, respawn)
    return centroids, _assign_tiled(xf, centroids, tile)
