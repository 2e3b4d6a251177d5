"""Tokenization (SURVEY.md §2.1): text → (ids, mask) numpy batches (a copy
of cloudvectordb_tpu/data/tokenize.py; ``tokenizers`` is imported inside
the methods that need it, so importing this module needs only numpy).

The environment is offline, so no pretrained vocab can be downloaded; the
default path trains a WordPiece tokenizer from the corpus itself (the
``tokenizers`` Rust library runs fully offline). A pretrained
``tokenizer.json`` (e.g. BERT/MiniLM vocab) is loaded when given, keeping
parity with HF-checkpoint encoders.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

PAD, UNK, CLS, SEP = "[PAD]", "[UNK]", "[CLS]", "[SEP]"


class TextTokenizer:
    def __init__(self, tok, max_len: int = 256):
        self._tok = tok
        self.max_len = max_len
        self.pad_id = tok.token_to_id(PAD) or 0

    @classmethod
    def train(
        cls,
        corpus: Iterable[str] | Iterator[str],
        vocab_size: int = 30522,
        max_len: int = 256,
    ) -> "TextTokenizer":
        from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, trainers
        from tokenizers.processors import TemplateProcessing

        tok = Tokenizer(models.WordPiece(unk_token=UNK))
        tok.normalizer = normalizers.BertNormalizer(lowercase=True)
        tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
        trainer = trainers.WordPieceTrainer(
            vocab_size=vocab_size, special_tokens=[PAD, UNK, CLS, SEP]
        )
        tok.train_from_iterator(corpus, trainer)
        tok.post_processor = TemplateProcessing(
            single=f"{CLS} $A {SEP}",
            special_tokens=[(CLS, tok.token_to_id(CLS)), (SEP, tok.token_to_id(SEP))],
        )
        return cls(tok, max_len)

    @classmethod
    def load(cls, path: str | Path, max_len: int = 256) -> "TextTokenizer":
        from tokenizers import Tokenizer

        return cls(Tokenizer.from_file(str(path)), max_len)

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._tok.save(str(path))

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode_batch(self, texts: list[str], max_len: int | None = None):
        """→ (ids (B, L) int32, mask (B, L) int32), truncated + padded."""
        max_len = max_len or self.max_len
        encs = self._tok.encode_batch(texts)
        ids = np.full((len(texts), max_len), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_len), np.int32)
        for r, e in enumerate(encs):
            n = min(len(e.ids), max_len)
            ids[r, :n] = e.ids[:n]
            mask[r, :n] = 1
        return ids, mask
