"""Product quantization: codebook training, encode, decode (counterpart of
cloudvectordb_tpu/index/pq.py: ``train_pq``, ``pq_encode``, ``pq_decode``,
``pq_reconstruction_mse``).

Training is m independent sub-space k-means runs (index/kmeans.py), one
after the other. The reference seeds sub-space j's k-means with ``seed +
j`` through ``jax.random.permutation``, a stream torch cannot reproduce, so
``train_pq`` takes ``init_codebooks=`` and parity tests feed both packages
the same init. Encoding is the nearest codeword per sub-space, the m
sub-spaces batched into one f32 product per row tile.

Not ported yet: the anisotropic (score-aware) codebooks ``train_pq_aniso``
and ``pq_encode_aniso`` (ROADMAP queue 1 item 13).
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
