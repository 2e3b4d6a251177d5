"""OPQ: a learned orthogonal rotation before PQ (counterpart of
cloudvectordb_tpu/index/opq.py::train_opq).

Alternating optimisation: fit PQ codebooks on the rotated sample, encode and
decode it, then solve the orthogonal Procrustes problem R = V·Uᵀ from the
SVD of Xᵀ·X̂ (``torch.linalg.svd``; U·Vᵀ does not depend on the signs the
SVD picks). All products are f32 with TF32 off.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from cloudvectordb_tpu_torch.index.pq import pq_decode, pq_encode, train_pq
from cloudvectordb_tpu_torch.utils.device import DEFAULT, as_device


def init_codebooks_from_perm(x: torch.Tensor, m: int, nbits: int, seed: int,
                             init_perm: Callable[[int], np.ndarray]) -> torch.Tensor:
    """(m, 2**nbits, D/m) k-means inits: sub-space j starts from the rows
    ``init_perm(seed + j)[:2**nbits]`` of x, the reference's init when
    ``init_perm`` is its ``jax.random.permutation`` (needs 2**nbits <= N)."""
    n, d = x.shape
    subs = x.float().view(n, m, d // m)
    rows = [torch.as_tensor(np.array(init_perm(seed + j)[: 2 ** nbits], np.int64), device=x.device)
            for j in range(m)]
    return torch.stack([subs[r, j] for j, r in enumerate(rows)])


def train_opq(x, m: int, nbits: int = 8, outer_iters: int = 8, pq_iters: int = 8,
              seed: int = 0, init_perm: Callable[[int], np.ndarray] | None = None,
              device: str | torch.device | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Rotation and codebooks learned on the sample x (N, D) on ``device``
    (default: a tensor's own device, the card for an array). Returns (R (D, D) f32 with
    x' = x @ R.T, codebooks (m, 2**nbits, D/m)), as numpy. Outer iteration
    ``it`` trains its codebooks with seed ``seed + it``; ``init_perm``, when
    given, supplies each sub-space k-means' init rows (see
    ``init_codebooks_from_perm``)."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else DEFAULT
    x = torch.as_tensor(x, dtype=torch.float32).to(as_device(device))
    d = x.shape[1]
    r = torch.eye(d, dtype=torch.float32, device=x.device)
    codebooks = None
    for it in range(outer_iters):
        xr = x @ r.T
        init = (None if init_perm is None
                else init_codebooks_from_perm(xr, m, nbits, seed + it, init_perm))
        codebooks = train_pq(xr, m, nbits, iters=pq_iters, seed=seed + it,
                             init_codebooks=init)
        x_hat = pq_decode(pq_encode(xr, codebooks), codebooks)
        # Procrustes: min_R ||x Rᵀ - x̂|| at R = V Uᵀ of SVD(xᵀ x̂)
        u, _, vt = torch.linalg.svd(x.T @ x_hat, full_matrices=False)
        r = (u @ vt).T
    return r.cpu().numpy(), codebooks.cpu().numpy()
