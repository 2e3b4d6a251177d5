"""Is WordPiece training deterministic? Trains the port's TextTokenizer
(data/tokenize.py, the JAX package's code) several times on one synthetic
corpus and prints how many distinct vocabularies (token -> id maps) came
out, and their sizes. Runs on the CPU in a few seconds:

    python scripts/torch_wordpiece_runs.py [--runs 3] [--docs 300] [--vocab 2048]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cloudvectordb_tpu_torch.data.synthetic import synthetic_corpus  # noqa: E402
from cloudvectordb_tpu_torch.data.tokenize import TextTokenizer  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--docs", type=int, default=300)
    ap.add_argument("--vocab", type=int, default=2048)
    args = ap.parse_args()
    corpus = synthetic_corpus(args.docs)
    vocabs = [tuple(sorted(TextTokenizer.train(corpus, vocab_size=args.vocab)
                           ._tok.get_vocab().items())) for _ in range(args.runs)]
    print(f"{args.runs} trainings on synthetic_corpus({args.docs}) at vocab {args.vocab}: "
          f"{len(set(vocabs))} distinct token -> id maps, sizes {[len(v) for v in vocabs]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
