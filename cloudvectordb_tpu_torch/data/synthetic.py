"""Synthetic vector/corpus generators + SIFT-format loaders (a copy of
cloudvectordb_tpu/data/synthetic.py, which imports only numpy).

The environment is offline, so BASELINE config #1 (SIFT1M exact top-10
harness) is exercised with synthetic clustered Gaussians of the same shape
(SURVEY.md §4.2); real ``.fvecs``/``.ivecs`` files load through the same API
when present on disk.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def clustered_vectors(
    n: int,
    dim: int,
    n_clusters: int = 64,
    seed: int = 0,
    dtype=np.float32,
    cluster_std: float = 0.6,
    normalize: bool = False,
    latent_dim: int | None = None,
) -> np.ndarray:
    """N vectors drawn from a mixture of Gaussians — realistic IVF workload.

    ``cluster_std`` is the noise NORM relative to the unit-norm centers
    (dimension-independent): the per-dim std is cluster_std/√dim.

    ``latent_dim``: synthesize in a low-dimensional latent and embed with a
    random linear map. Real embedding corpora have low intrinsic dimension;
    isotropic high-d Gaussians concentrate all pairwise distances (no
    neighbor margins), which makes quantized-search recall artificially low.
    """
    rng = np.random.default_rng(seed)
    d_eff = latent_dim or dim
    centers = rng.normal(size=(n_clusters, d_eff)).astype(np.float64)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, size=n)
    x = centers[assign] + (cluster_std / np.sqrt(d_eff)) * rng.normal(
        size=(n, d_eff)
    )
    if latent_dim:
        w = rng.normal(size=(d_eff, dim)) / np.sqrt(d_eff)
        x = x @ w
    x = x.astype(dtype)
    if normalize:
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    return x


def queries_from(
    base: np.ndarray, nq: int, seed: int = 1, noise: float = 0.25, normalize: bool = False
) -> np.ndarray:
    """Queries near existing DB vectors — exercises recall where it's
    nontrivial. ``noise`` is the perturbation norm (dimension-independent)."""
    rng = np.random.default_rng(seed)
    d = base.shape[1]
    idx = rng.integers(0, base.shape[0], size=nq)
    q = base[idx] + (noise / np.sqrt(d)) * rng.normal(size=(nq, d)).astype(base.dtype)
    q = q.astype(base.dtype)
    if normalize:
        q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    return q


def read_fvecs(path: str | Path, max_rows: int | None = None) -> np.ndarray:
    """SIFT1M-format .fvecs: per row an int32 dim then dim float32s."""
    raw = np.fromfile(path, dtype=np.int32)
    dim = raw[0]
    rows = raw.reshape(-1, dim + 1)
    if max_rows is not None:
        rows = rows[:max_rows]
    return rows[:, 1:].view(np.float32).copy()


def read_ivecs(path: str | Path, max_rows: int | None = None) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    dim = raw[0]
    rows = raw.reshape(-1, dim + 1)
    if max_rows is not None:
        rows = rows[:max_rows]
    return rows[:, 1:].copy()


def synthetic_corpus(num_docs: int, seed: int = 0) -> list[str]:
    """Tiny synthetic text corpus: topic-templated sentences, so that documents
    sharing a topic are true semantic neighbors (gives mining/eval signal)."""
    rng = np.random.default_rng(seed)
    topics = [
        ("astronomy", ["telescope", "galaxy", "orbit", "nebula", "supernova", "planet"]),
        ("cooking", ["recipe", "oven", "saute", "flavor", "ingredient", "simmer"]),
        ("finance", ["market", "equity", "dividend", "portfolio", "interest", "bond"]),
        ("biology", ["cell", "protein", "genome", "enzyme", "membrane", "organism"]),
        ("music", ["melody", "rhythm", "chord", "orchestra", "tempo", "harmony"]),
        ("sports", ["tournament", "goal", "athlete", "league", "stadium", "coach"]),
        ("computing", ["compiler", "kernel", "network", "algorithm", "memory", "cache"]),
        ("geography", ["river", "mountain", "climate", "desert", "coast", "valley"]),
    ]
    docs = []
    for i in range(num_docs):
        t = int(rng.integers(0, len(topics)))
        name, words = topics[t]
        picks = rng.choice(words, size=4, replace=True)
        docs.append(
            f"document {i} about {name}: the {picks[0]} and the {picks[1]} "
            f"relate to {picks[2]} through the {picks[3]}."
        )
    return docs
