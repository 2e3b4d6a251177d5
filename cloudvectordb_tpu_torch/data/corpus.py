"""Corpus streaming (a copy of cloudvectordb_tpu/data/corpus.py, which
imports no JAX): very large text corpora without loading into RAM.

Sources:
  synthetic         — offline topic-templated generator (tests / smoke runs)
  file:<path>       — one document per line (.txt) or JSONL with a text field
  hf:<name>[:cfg]   — HuggingFace datasets streaming (gated: needs the
                      ``datasets`` package and a local datasets cache;
                      ``datasets`` is imported only when this source is read)

Long documents are chunk-and-pooled at the data layer: split into ≤max-word
passages with overlap; each passage is encoded/indexed independently.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator

from cloudvectordb_tpu_torch.data.synthetic import synthetic_corpus
from cloudvectordb_tpu_torch.utils.config import DataConfig


def chunk_document(text: str, max_words: int = 180, stride: int = 140) -> list[str]:
    """Overlapping word-window chunks; tiny docs pass through unchanged.

    stride > max_words would silently DROP the words between windows —
    clamp so every word lands in at least one chunk.
    """
    stride = min(stride, max_words)
    words = text.split()
    if len(words) <= max_words:
        return [text]
    chunks = []
    start = 0
    while start < len(words):
        chunks.append(" ".join(words[start : start + max_words]))
        if start + max_words >= len(words):
            break
        start += stride
    return chunks


def _iter_file(path: str, text_field: str) -> Iterator[str]:
    p = Path(path)
    with p.open() as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if p.suffix == ".jsonl":
                yield json.loads(line)[text_field]
            else:
                yield line


def _iter_hf(name: str, split: str, text_field: str) -> Iterator[str]:
    import datasets

    parts = name.split(":")
    ds = datasets.load_dataset(
        parts[0], parts[1] if len(parts) > 1 else None, split=split, streaming=True
    )
    for rec in ds:
        yield rec[text_field]


def stream_corpus(cfg: DataConfig) -> Iterator[tuple[int, str]]:
    """Yields (doc_id, passage_text). One doc may emit several passages
    (chunk-and-pool); doc_id identifies the source document."""
    if cfg.corpus == "synthetic":
        src: Iterator[str] = iter(synthetic_corpus(cfg.num_docs, seed=cfg.seed))
    elif cfg.corpus.startswith("file:"):
        src = _iter_file(cfg.corpus[5:], cfg.text_field)
    elif cfg.corpus.startswith("hf:"):
        src = _iter_hf(cfg.corpus[3:], cfg.split, cfg.text_field)
    else:
        raise ValueError(f"unknown corpus source {cfg.corpus!r}")

    for doc_id, text in enumerate(src):
        if cfg.num_docs and doc_id >= cfg.num_docs:
            break
        if cfg.chunk_long_docs:
            for chunk in chunk_document(text, stride=cfg.chunk_stride):
                yield doc_id, chunk
        else:
            yield doc_id, text


def load_passages(cfg: DataConfig) -> tuple[list[str], list[int]]:
    """Materialize (passages, doc_ids) — for corpora that fit in host RAM."""
    passages, doc_ids = [], []
    for doc_id, text in stream_corpus(cfg):
        passages.append(text)
        doc_ids.append(doc_id)
    return passages, doc_ids
