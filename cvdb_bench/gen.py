"""Traffic and data generation, frozen here as the benchmark's yardstick.

A copy of the synthetic process of the reference's benches (``bench.py``;
the port keeps its own copy in ``cloudvectordb_tpu_torch/eval/harness.py``):
a 32-d latent of 256 unit centres, noise 0.3/sqrt(32), a random linear map
to D, rows L2-normalised; queries are noisy copies of rows (noise norm
0.15), L2-normalised.

The corpus is the deployment's dataset: its map, centres and rows are
drawn from the configuration's ``corpus_seed``, the same for every run,
as a benchmark's dataset is one fixed file. The run's ``--seed`` draws the
traffic: the query pool, the judged batches and the rows added in set-up
(further rows of the same process). So one seed gives one query pool and
one set of added rows, and every seed gives the same sizes over the same
index: the seed cannot change how hard the index is to search.
Everything is drawn on the device from ``torch.Generator``s.
"""

from __future__ import annotations

import numpy as np
import torch

LATENT, NCENTERS = 32, 256


def derive(seed: int, *tags: int) -> int:
    """A 63-bit generator seed for (seed, *tags): any whole seed, however
    large, and distinct tags give independent streams."""
    words = np.random.SeedSequence([int(seed) & (2**128 - 1), *tags]).generate_state(2)
    return int((int(words[0]) << 31) ^ int(words[1])) & (2**63 - 1)


#: stream tags of derive()
MAP, CHUNK, QUERY, ADDED, SCORED = 1, 2, 3, 4, 5


def chunk_sizes(n: int, chunk: int) -> list[int]:
    """Full chunks, then the remainder."""
    return [chunk] * (n // chunk) + ([n % chunk] if n % chunk else [])


def latent_corpus(dev: torch.device, d: int, corpus_seed: int):
    """rows(stream, m) -> (m, d) f32 unit rows on ``dev`` of the process of
    ``corpus_seed`` (its map and centres), deterministic: the draws of one
    ``stream`` (a derive() seed) give the same rows every time."""
    g = torch.Generator(device=dev)
    g.manual_seed(derive(corpus_seed, MAP))
    w = torch.randn((LATENT, d), generator=g, device=dev) / LATENT ** 0.5
    centers = torch.randn((NCENTERS, LATENT), generator=g, device=dev)
    centers = centers / centers.norm(dim=1, keepdim=True)

    def chunk_fn(stream: int, m: int) -> torch.Tensor:
        gi = torch.Generator(device=dev)
        gi.manual_seed(stream)
        a = torch.randint(0, NCENTERS, (m,), generator=gi, device=dev)
        z = centers[a] + (0.3 / LATENT ** 0.5) * torch.randn((m, LATENT), generator=gi,
                                                             device=dev)
        x = z @ w
        return x / x.norm(dim=1, keepdim=True)

    return chunk_fn


def noisy_queries(base: torch.Tensor, batch: int, seed: int, noise: float = 0.15):
    """``batch`` noisy copies of rows of ``base`` (noise norm ``noise``),
    L2-normalised, drawn on ``base``'s device from ``seed``."""
    g = torch.Generator(device=base.device)
    g.manual_seed(seed)
    d = base.shape[1]
    sel = torch.randint(0, base.shape[0], (batch,), generator=g, device=base.device)
    q = base[sel] + (noise / d ** 0.5) * torch.randn((batch, d), generator=g,
                                                     device=base.device)
    return q / q.norm(dim=1, keepdim=True)


class Data:
    """The corpus, the added rows and the query pool of one run.

    Rows 0..rows-1 are the corpus in chunks of ``chunk_rows``, drawn from
    the configuration's ``corpus_seed``; the added rows are further chunks
    of the same process drawn from the run's seed, global ids
    rows..rows+added-1 in insertion order. The query pool is
    ``pool_batches`` batches of ``batch`` noisy copies of rows of chunk 0,
    and, where ``query_from_added`` > 0, that share of each batch copies
    added rows instead."""

    def __init__(self, dev, cfg: dict, mix: dict, seed: int):
        self.dev, self.seed = dev, seed
        self.d = int(cfg["dim"])
        self.sizes = chunk_sizes(int(cfg["rows"]), int(cfg["chunk_rows"]))
        self.added_sizes = chunk_sizes(int(mix.get("added_rows", 0)), int(cfg["chunk_rows"]))
        self.rows = sum(self.sizes)
        self.added = sum(self.added_sizes)
        self.corpus_seed = int(cfg["corpus_seed"])
        self._fn = latent_corpus(dev, self.d, self.corpus_seed)
        self.mix = mix

    def chunk(self, i: int) -> torch.Tensor:
        return self._fn(derive(self.corpus_seed, CHUNK, i), self.sizes[i])

    def added_chunk(self, j: int) -> torch.Tensor:
        return self._fn(derive(self.seed, ADDED, j), self.added_sizes[j])

    def all_chunks(self):
        """(global id of the first row, chunk fn) of every row the index
        holds: the corpus, then the added rows."""
        base = 0
        for i in range(len(self.sizes)):
            yield base, (lambda i=i: self.chunk(i))
            base += self.sizes[i]
        for j in range(len(self.added_sizes)):
            yield base, (lambda j=j: self.added_chunk(j))
            base += self.added_sizes[j]

    def query_pool(self) -> list[torch.Tensor]:
        mix = self.mix
        b, nb = int(mix["batch"]), int(mix["pool_batches"])
        share = float(mix.get("query_from_added", 0.0))
        n_add = int(round(b * share)) if self.added else 0
        base = self.chunk(0)
        added = self.added_chunk(0) if n_add else None
        pool = []
        for i in range(nb):
            q = noisy_queries(base, b - n_add, derive(self.seed, QUERY, i), float(mix["noise"]))
            if n_add:
                qa = noisy_queries(added, n_add, derive(self.seed, QUERY, nb + i),
                                   float(mix["noise"]))
                q = torch.cat([q, qa])
            pool.append(q.contiguous())
        return pool

    def scored_batches(self) -> list[int]:
        """The pool batches whose answers are judged, drawn from the seed."""
        nb, ns = int(self.mix["pool_batches"]), int(self.mix["scored_batches"])
        rng = np.random.default_rng(derive(self.seed, SCORED))
        return sorted(int(i) for i in rng.choice(nb, size=min(ns, nb), replace=False))
