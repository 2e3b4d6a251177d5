"""Product quantization: codebook training, encode, decode (counterpart of
cloudvectordb_tpu/index/pq.py: ``train_pq``, ``train_pq_aniso``,
``pq_encode``, ``pq_encode_aniso``, ``pq_decode``,
``pq_reconstruction_mse``).

Training is m independent sub-space k-means runs (index/kmeans.py), one
after the other. The reference seeds sub-space j's k-means with ``seed +
j`` through ``jax.random.permutation``, a stream torch cannot reproduce, so
``train_pq`` takes ``init_codebooks=`` and parity tests feed both packages
the same init. Encoding is the nearest codeword per sub-space, the m
sub-spaces batched into one f32 product per row tile.

Anisotropic (score-aware) codebooks weigh the error along each sub-vector's
score direction by ``eta``: per point ``‖e‖² + (eta - 1)(u·e)²`` with u the
unit sub-vector of the datapoint (the full row, not its residual). Training
is Lloyd with that assignment rule and the per-codeword normal equations
``(n_k I + (eta - 1) Σ u uᵀ) c = Σ x + (eta - 1) Σ (u·x) u``; encoding uses
the same rule. ``train_pq_aniso`` takes ``init_codebooks=`` as ``train_pq``
does (the start of its two k-means warm-up iterations per sub-space).
"""

from __future__ import annotations

import torch

from cloudvectordb_tpu_torch.index.kmeans import train_kmeans


def _split(x: torch.Tensor, m: int) -> torch.Tensor:
    """(N, D) -> (N, m, D/m) sub-vectors (a view)."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by m={m}")
    return x.view(n, m, d // m)


def train_pq(x: torch.Tensor, m: int, nbits: int = 8, iters: int = 12, seed: int = 0,
             init_codebooks: torch.Tensor | None = None) -> torch.Tensor:
    """Codebooks (m, 2**nbits, D/m) f32 trained on (N, D) vectors, on x's
    device. Sub-space j runs ``iters`` Lloyd iterations from
    ``init_codebooks[j]`` when given, else from an init seeded with
    ``seed + j``."""
    subs = _split(x.float(), m)
    out = []
    for j in range(m):
        init = None if init_codebooks is None else init_codebooks[j]
        c, _ = train_kmeans(subs[:, j].contiguous(), 2 ** nbits, iters=iters,
                            seed=seed + j, tile=4096, init_centroids=init)
        out.append(c)
    return torch.stack(out)


def _unit(u: torch.Tensor) -> torch.Tensor:
    """Rows of ``u`` over their norms (floored at 1e-9), the last axis."""
    return u / torch.clamp_min(torch.linalg.vector_norm(u, dim=-1, keepdim=True), 1e-9)


def _aniso_assign(sub, u, p, x_sq, cb, etam1, tile: int) -> torch.Tensor:
    """(N,) argmin over codewords of ``‖x‖² - 2 x·c + ‖c‖² + (eta-1)(p -
    u·c)²`` for (N, ds) sub-vectors, a row tile at a time (the first minimum
    on ties, as ``jnp.argmin``)."""
    cb_sq = (cb * cb).sum(dim=1)
    parts = []
    for s in range(0, sub.shape[0], tile):
        base = x_sq[s:s + tile, None] - 2.0 * (sub[s:s + tile] @ cb.T) + cb_sq[None, :]
        dlt = p[s:s + tile, None] - u[s:s + tile] @ cb.T
        parts.append(torch.argmin(base + etam1 * dlt * dlt, dim=1))
    return torch.cat(parts)


def train_pq_aniso(x: torch.Tensor, xdir: torch.Tensor, m: int, nbits: int = 8,
                   iters: int = 8, eta: float = 4.0, seed: int = 0, tile: int = 4096,
                   init_codebooks: torch.Tensor | None = None) -> torch.Tensor:
    """Anisotropic codebooks (m, 2**nbits, D/m) f32 on (N, D) vectors ``x``
    with score directions ``xdir`` (module docstring): per sub-space two
    k-means iterations from ``init_codebooks[j]`` (else an init seeded with
    ``seed + j``), then ``iters`` rounds of the anisotropic assignment and
    the batched (ds, ds) normal-equation solves; a codeword no point takes
    keeps its value. On x's device, in f32."""
    ncode = 2 ** nbits
    n, d = x.shape
    ds = d // m
    subs = _split(x.float(), m)
    us = _unit(_split(xdir.float(), m))
    etam1 = torch.tensor(eta - 1.0, dtype=torch.float32, device=x.device)
    eye = torch.eye(ds, dtype=torch.float32, device=x.device)
    out = []
    for j in range(m):
        sub = subs[:, j].contiguous()
        u = us[:, j].contiguous()
        p = (u * sub).sum(dim=1)
        x_sq = (sub * sub).sum(dim=1)
        init = None if init_codebooks is None else init_codebooks[j]
        cb, _ = train_kmeans(sub, ncode, iters=2, seed=seed + j, tile=tile, init_centroids=init)
        uu = (u[:, :, None] * u[:, None, :]).reshape(n, ds * ds)
        rhs_rows = sub + etam1 * p[:, None] * u
        for _ in range(iters):
            a = _aniso_assign(sub, u, p, x_sq, cb, etam1, tile)
            nk = torch.bincount(a, minlength=ncode).float()
            uu_k = torch.zeros((ncode, ds * ds), device=x.device).index_add_(0, a, uu)
            mat = etam1 * uu_k.reshape(ncode, ds, ds) + (nk[:, None, None] + 1e-6) * eye
            b = torch.zeros((ncode, ds), device=x.device).index_add_(0, a, rhs_rows)
            cb_new = torch.linalg.solve(mat, b[..., None])[..., 0]
            cb = torch.where((nk > 0)[:, None], cb_new, cb)
        out.append(cb)
    return torch.stack(out)


def pq_encode_aniso(x: torch.Tensor, xdir: torch.Tensor, codebooks: torch.Tensor,
                    eta: float, tile: int = 4096) -> torch.Tensor:
    """(N, D) -> (N, m) uint8 codes under the anisotropic metric the
    codebooks were trained with: per sub-space the codeword minimising
    ``‖x‖² - 2 x·c + ‖c‖² + (eta - 1)(u·x - u·c)²``, u the unit sub-vector
    of ``xdir``; a row tile at a time, all sub-spaces in one batched
    product."""
    cb = codebooks.to(device=x.device, dtype=torch.float32)
    m = cb.shape[0]
    etam1 = torch.tensor(eta - 1.0, dtype=torch.float32, device=x.device)
    cbt = cb.transpose(1, 2)  # (m, ds, ncode)
    cb_sq = (cb * cb).sum(dim=2)[:, None, :]  # (m, 1, ncode)
    xs_all, us_all = _split(x.float(), m), _split(xdir.float(), m)
    parts = []
    for s in range(0, x.shape[0], tile):
        xs = xs_all[s:s + tile].transpose(0, 1)  # (m, T, ds)
        us = _unit(us_all[s:s + tile]).transpose(0, 1)
        p = (us * xs).sum(dim=2)
        x_sq = (xs * xs).sum(dim=2)
        dlt = p[:, :, None] - torch.bmm(us, cbt)
        dist = x_sq[:, :, None] - 2.0 * torch.bmm(xs, cbt) + cb_sq + etam1 * dlt * dlt
        parts.append(torch.argmin(dist, dim=2).T.to(torch.uint8))
    if not parts:
        return torch.zeros((0, m), dtype=torch.uint8, device=x.device)
    return torch.cat(parts).contiguous()


def pq_encode(x: torch.Tensor, codebooks: torch.Tensor, tile: int = 4096) -> torch.Tensor:
    """(N, D) -> (N, m) uint8 codes: per sub-space the codeword maximising
    x·c - ||c||²/2 (the nearest one; ties to the lower code, as
    ``jnp.argmax``), computed one row tile at a time."""
    cb = codebooks.to(device=x.device, dtype=torch.float32)
    m = cb.shape[0]
    cbt = cb.transpose(1, 2)  # (m, dsub, ncode)
    half_sq = 0.5 * (cb * cb).sum(dim=2)[:, None, :]  # (m, 1, ncode)
    subs = _split(x.float(), m)
    parts = []
    for s in range(0, x.shape[0], tile):
        blk = subs[s:s + tile].transpose(0, 1)  # (m, T, dsub)
        score = torch.bmm(blk, cbt) - half_sq
        parts.append(torch.argmax(score, dim=2).T.to(torch.uint8))
    if not parts:
        return torch.zeros((0, m), dtype=torch.uint8, device=x.device)
    return torch.cat(parts).contiguous()


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(N, m) uint8 codes -> (N, D) f32 reconstructions (a gather)."""
    cb = codebooks.to(device=codes.device, dtype=torch.float32)
    m = cb.shape[0]
    sub = torch.arange(m, device=codes.device)[None, :]
    return cb[sub, codes.long()].reshape(codes.shape[0], -1)


def pq_reconstruction_mse(x: torch.Tensor, codebooks: torch.Tensor) -> float:
    xr = pq_decode(pq_encode(x, codebooks), codebooks)
    return float(((x.float() - xr) ** 2).sum(dim=1).mean())
