"""Nearest-centroid assignment, argmin_c ||x - c||² as tiled matmuls
(counterpart of cloudvectordb_tpu/ops/assign.py).

Distances are expanded so the N×C interaction is one f32 matmul per row
tile; the full (N, C) matrix is never materialized.
"""

from __future__ import annotations

import torch


def _assign_block(x: torch.Tensor, centroids: torch.Tensor,
                  c_sqnorm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, D) x (C, D) -> (assignment (T,), x·c - ||c||²/2 of it (T,))."""
    # argmin ||x-c||² == argmax (x·c - ||c||²/2); the ||x||² term is constant.
    score = x.float() @ centroids.T - 0.5 * c_sqnorm[None, :]
    # argmax returns the first maximum, as jnp.argmax: ties go to the lower id
    return torch.argmax(score, dim=1), score.amax(dim=1)


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor,
                    tile: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid id and true squared distance for every row of x.

    Returns (assign (N,) int64, sqdist (N,) f32), on x's device. Peak memory
    is O(tile × C) regardless of N.
    """
    centroids = centroids.float()
    c_sqnorm = (centroids * centroids).sum(dim=1)
    a_parts, best_parts = [], []
    for start in range(0, x.shape[0], tile):
        a, best = _assign_block(x[start : start + tile], centroids, c_sqnorm)
        a_parts.append(a)
        best_parts.append(best)
    a = torch.cat(a_parts)
    best = torch.cat(best_parts)
    xf = x.float()
    sqdist = (xf * xf).sum(dim=1) - 2.0 * best  # ||x||² - 2(x·c - ||c||²/2)
    return a, sqdist.clamp_min(0.0)
