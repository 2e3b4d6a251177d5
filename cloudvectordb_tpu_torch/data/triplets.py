"""Triplet mining — stage 1 of the pipeline (a copy of
cloudvectordb_tpu/data/triplets.py: the same RNG draws, so the same
triplets from the same passages).

Strategies (SURVEY.md §2.1 Triplet miner):
  inbatch — self-supervised inverse-cloze-style pairs: (anchor span, positive
            span) drawn from the same document, negative from a random other
            document. Needs no labels; in-batch negatives do the heavy
            lifting during InfoNCE training.
  hard    — index-assisted: encode the corpus with the *current* encoder,
            build an index (L3), and for each anchor sample a negative from
            retrieval ranks [hard_skip, hard_topk) — near misses, the
            negatives that actually move a contrastive model. The index is
            the port's (on the card, ``FlatIndex.search``: K2); its unfilled
            result slots are (-inf, -1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from cloudvectordb_tpu_torch.utils.config import MiningConfig
from cloudvectordb_tpu_torch.utils.metrics import get_logger

log = get_logger("cvdb.mine")


@dataclass
class Triplets:
    anchors: list[str]
    positives: list[str]
    negatives: list[str]

    def __len__(self) -> int:
        return len(self.anchors)

    def save(self, path) -> None:
        import json
        from pathlib import Path

        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with p.open("w") as fh:
            for a, pp, n in zip(self.anchors, self.positives, self.negatives):
                fh.write(json.dumps({"anchor": a, "positive": pp, "negative": n}) + "\n")

    @classmethod
    def load(cls, path) -> "Triplets":
        import json

        a, p, n = [], [], []
        with open(path) as fh:
            for line in fh:
                rec = json.loads(line)
                a.append(rec["anchor"])
                p.append(rec["positive"])
                n.append(rec["negative"])
        return cls(a, p, n)


def _split_spans(text: str, rng) -> tuple[str, str]:
    """Two disjoint halves of a passage (inverse-cloze-style pair)."""
    words = text.split()
    if len(words) < 4:
        return text, text
    cut = rng.integers(2, len(words) - 1)
    a, b = " ".join(words[:cut]), " ".join(words[cut:])
    return (a, b) if rng.integers(2) else (b, a)


def mine_triplets(
    passages: list[str],
    doc_ids: list[int],
    cfg: MiningConfig,
    encode_fn: Callable[[list[str]], np.ndarray] | None = None,
    index=None,
) -> Triplets:
    """passages/doc_ids from the corpus layer; encode_fn+index enable 'hard'."""
    rng = np.random.default_rng(cfg.seed)
    n_pass = len(passages)
    doc_ids = np.asarray(doc_ids)
    anchors, positives, negatives = [], [], []

    hard_neg_of = None
    if cfg.strategy == "hard":
        if encode_fn is None or index is None:
            raise ValueError("hard mining needs encode_fn and a built index")
        log.info("hard mining: retrieving negatives for %d anchors", cfg.num_triplets)

    picks = rng.integers(0, n_pass, size=cfg.num_triplets)
    if cfg.strategy == "hard":
        # retrieve near-misses for every anchor passage in batches
        hard_neg_of = np.zeros(cfg.num_triplets, np.int64)
        bs = 512
        for s in range(0, cfg.num_triplets, bs):
            batch_idx = picks[s : s + bs]
            q = encode_fn([passages[i] for i in batch_idx])
            sc, ids = index.search(q, cfg.hard_topk)
            sc = np.asarray(sc)
            for r, anchor_i in enumerate(batch_idx):
                # unfilled result slots: (-inf, -1) in the port, (-inf, id
                # 0) in some of the reference's kinds; the finite score and
                # the id range reject both
                cand = [
                    int(c)
                    for ci, c in enumerate(ids[r][cfg.hard_skip :],
                                           start=cfg.hard_skip)
                    if np.isfinite(sc[r][ci])
                    and 0 <= int(c) < n_pass
                    and doc_ids[int(c)] != doc_ids[anchor_i]
                ]
                hard_neg_of[s + r] = (
                    rng.choice(cand) if cand else rng.integers(0, n_pass)
                )

    for t, i in enumerate(picks):
        a, p = _split_spans(passages[i], rng)
        if cfg.strategy == "hard":
            j = int(hard_neg_of[t])
        else:
            j = int(rng.integers(0, n_pass))
            while doc_ids[j] == doc_ids[i] and n_pass > 1:
                j = int(rng.integers(0, n_pass))
        anchors.append(a)
        positives.append(p)
        negatives.append(passages[j])
    return Triplets(anchors, positives, negatives)


def load_pairs(path, query_field: str = "query", positive_field: str = "positive"):
    """JSONL (query, positive) pairs — the MS-MARCO-style supervision format
    (BASELINE config #3). Returns (queries, positives) lists."""
    import json

    qs, ps = [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            qs.append(rec[query_field])
            ps.append(rec[positive_field])
    return qs, ps


def mine_triplets_from_pairs(
    queries: list[str],
    positives: list[str],
    cfg: MiningConfig,
    encode_fn: Callable[[list[str]], np.ndarray] | None = None,
    index=None,
) -> Triplets:
    """Supervised mining from (query, positive) pairs: anchors are queries,
    negatives are random other positives ('inbatch') or retrieval near-misses
    from an index over the positives pool ('hard')."""
    assert len(queries) == len(positives)
    rng = np.random.default_rng(cfg.seed)
    n = len(queries)
    # honor num_triplets > n by oversampling with replacement (matching
    # mine_triplets) instead of silently mining fewer than requested
    count = cfg.num_triplets if cfg.num_triplets else n
    picks = rng.choice(n, size=count, replace=count > n)
    anchors, pos_out, neg_out = [], [], []
    hard_neg = None
    if cfg.strategy == "hard":
        if encode_fn is None or index is None:
            raise ValueError("hard mining needs encode_fn and a built index")
        hard_neg = np.zeros(count, np.int64)
        bs = 512
        for s in range(0, count, bs):
            batch_idx = picks[s : s + bs]
            qv = encode_fn([queries[i] for i in batch_idx])
            sc, ids = index.search(qv, cfg.hard_topk)
            sc = np.asarray(sc)
            for r, qi in enumerate(batch_idx):
                cand = [
                    int(c)
                    for ci, c in enumerate(ids[r][cfg.hard_skip :],
                                           start=cfg.hard_skip)
                    if np.isfinite(sc[r][ci]) and 0 <= int(c) < n
                    and int(c) != qi
                ]
                hard_neg[s + r] = rng.choice(cand) if cand else rng.integers(0, n)
    for t, i in enumerate(picks):
        if hard_neg is not None:
            j = int(hard_neg[t])
        else:
            j = int(rng.integers(0, n))
            while j == i and n > 1:
                j = int(rng.integers(0, n))
        anchors.append(queries[i])
        pos_out.append(positives[i])
        neg_out.append(positives[j])
    return Triplets(anchors, pos_out, neg_out)


class triplet_batches:
    """Shuffled, tokenized train batches (drop-remainder for static shapes).

    An iterator CLASS rather than a generator so checkpoint resume can
    fast-forward with ``skip(n)`` — advancing the deterministic
    (epoch, position) cursor and RNG stream WITHOUT tokenizing the skipped
    batches (a generator-consuming resume tokenized 3·batch_size texts per
    skipped step, minutes of host CPU at step 10k).

    Fewer triplets than one batch is a config error, not a silent epoch of
    zero batches (with epochs=None the loop would otherwise spin forever
    yielding nothing and training would hang).
    """

    def __init__(
        self,
        triplets: Triplets,
        tokenizer,
        batch_size: int,
        max_len: int,
        seed: int = 0,
        epochs: int | None = None,
    ):
        n = len(triplets)
        if n < batch_size:
            raise ValueError(
                f"{n} triplets < batch_size={batch_size}: raise "
                "mining.num_triplets or lower train.batch_size"
            )
        self._t = triplets
        self._tok = tokenizer
        self._bs = batch_size
        self._ml = max_len
        self._rng = np.random.default_rng(seed)
        self._epochs = epochs
        self._n = n
        self._bpe = n // batch_size  # batches per epoch (drop remainder)
        self._epoch = 0
        self._pos = 0
        self._order: np.ndarray | None = None

    def __iter__(self) -> "triplet_batches":
        return self

    def _advance(self) -> np.ndarray | None:
        """Step the cursor; returns the batch's index selection or None at
        the end of the (bounded) stream. Identical RNG consumption whether
        batches are materialized or skipped."""
        while True:
            if self._epochs is not None and self._epoch >= self._epochs:
                return None
            if self._order is None:
                self._order = self._rng.permutation(self._n)
            if self._pos >= self._bpe:
                self._epoch += 1
                self._pos = 0
                self._order = None
                continue
            sel = self._order[self._pos * self._bs : (self._pos + 1) * self._bs]
            self._pos += 1
            return sel

    def skip(self, count: int) -> None:
        """Fast-forward `count` batches (no tokenization)."""
        for _ in range(count):
            if self._advance() is None:
                return

    def __next__(self) -> dict:
        sel = self._advance()
        if sel is None:
            raise StopIteration
        a_ids, a_mask = self._tok.encode_batch(
            [self._t.anchors[i] for i in sel], self._ml
        )
        p_ids, p_mask = self._tok.encode_batch(
            [self._t.positives[i] for i in sel], self._ml
        )
        n_ids, n_mask = self._tok.encode_batch(
            [self._t.negatives[i] for i in sel], self._ml
        )
        return {
            "anchor_ids": a_ids, "anchor_mask": a_mask,
            "pos_ids": p_ids, "pos_mask": p_mask,
            "neg_ids": n_ids, "neg_mask": n_mask,
        }
