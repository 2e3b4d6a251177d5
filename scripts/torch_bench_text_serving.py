"""Text in, results out (counterpart of scripts/bench_text_serving.py).

A query arrives as text, so serving costs tokenize (host) + encoder forward
(card) + index search (card). This script times the legs apart and end to
end at B in {1, 64, 4096} on the 12.5M x 768 residual-int8 tiles index, with
the query-side encoder's op point stated: queries truncated to L tokens,
bf16, a MiniLM-L6-class encoder (22M parameters) with a 768-d projection,
random weights from seed 0 (its cost, not its recall, is measured here).

The query embeddings stay on the card: the encoder's output feeds
``search_device`` and only the (B, k) ids cross to the host. Each leg is
fenced: the encode and the search by CUDA events, the tokenizer and the end
to end by the host clock between ``torch.cuda.synchronize()`` fences. At
L=32 the encoder packs four queries into a 128-row block-diagonal
attention ('packed_batch', plain torch ops, as the reference's is plain
XLA) when B is a multiple of 4, else takes 'naive'; K4 needs L % 128 == 0.
K1 serves every search.

    python scripts/torch_bench_text_serving.py

Env: N (12.5M), P (448), TQ (128), L (32). Ends with one JSON line.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cloudvectordb_tpu_torch.data.tokenize import TextTokenizer  # noqa: E402
from cloudvectordb_tpu_torch.eval import harness  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex  # noqa: E402
from cloudvectordb_tpu_torch.models.embed import make_encode_fn  # noqa: E402
from cloudvectordb_tpu_torch.models.encoder import init_encoder  # noqa: E402
from cloudvectordb_tpu_torch.utils.config import EncoderConfig  # noqa: E402
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

D, NLIST = 768, 4096
CHUNK = 500_000
K = 10
BATCHES = (1, 64, 4096)
#: the query-side encoder (MiniLM-L6 class with a projection to D)
ENCODER = dict(hidden_dim=384, num_layers=6, num_heads=12, mlp_dim=1536, dropout=0.0,
               dtype="bfloat16")
VOCAB = 8192
TOKENIZE_REPS = 5


def main(argv=None, device="cuda") -> dict:
    dev = as_device(device)
    n = int(os.environ.get("N", 12_500_000))
    p_env = int(os.environ.get("P", 448))
    tq_env = int(os.environ.get("TQ", 128))
    length = int(os.environ.get("L", 32))
    card = harness.card_line(dev)
    sizes = harness.chunk_sizes(n, CHUNK)
    harness.reset_launches()
    t0 = time.perf_counter()
    idx = BandIVFIndex.build_device_streaming(harness.latent_corpus(dev, D, sizes), len(sizes),
                                              nlist=NLIST, kmeans_iters=10, residual=True,
                                              device=dev)
    harness.sync(dev)
    build_s = time.perf_counter() - t0
    print(f"index build {build_s:.1f}s n={idx.ntotal}; {card}", flush=True)

    cfg = EncoderConfig(max_len=length, out_dim=D, **ENCODER)
    encode = make_encode_fn(init_encoder(cfg, seed=0, device=dev), device=dev)
    tok = TextTokenizer.train([f"synthetic passage about topic {i} with words" for i in range(512)],
                              vocab_size=VOCAB)
    texts = [f"query about topic {i % 500} and concept {i % 37}" for i in range(max(BATCHES))]
    n_tiles = idx._tune_n_tiles()
    report = {}
    for b in BATCHES:
        bt = texts[:b]
        ids_np, mask_np = tok.encode_batch(bt, length)
        tq = min(tq_env, max(8, 1 << (b - 1).bit_length()))
        p_t = min(p_env, n_tiles)
        reps = 8 if b <= 64 else 4

        # (1) tokenize only (host)
        t0 = time.perf_counter()
        for _ in range(TOKENIZE_REPS):
            tok.encode_batch(bt, length)
        t_tok = (time.perf_counter() - t0) / TOKENIZE_REPS * 1e3

        # (2) encode only (card)
        ids_d = torch.as_tensor(ids_np, device=dev)
        mask_d = torch.as_tensor(mask_np, device=dev)
        emb = encode(ids_d, mask_d)  # warm
        t_enc = float(np.median(harness.device_ms(lambda i: encode(ids_d, mask_d), dev, reps)))

        # (3) search only (queries on the card)
        idx.search_device(emb, K, p_tiles=p_t, tile_q=tq)  # warm
        t_sea = float(np.median(harness.device_ms(
            lambda i: idx.search_device(emb + 1e-6 * (i + 1), K, p_tiles=p_t, tile_q=tq), dev,
            reps)))

        # (4) end to end: tokenize, encode, search_device, ids to the host
        def e2e():
            ii, mm = tok.encode_batch(bt, length)
            e = encode(torch.as_tensor(ii, device=dev), torch.as_tensor(mm, device=dev))
            return idx.search_device(e, K, p_tiles=p_t, tile_q=tq)[1].cpu().numpy()

        e2e()  # warm
        t_e2e = float(np.median([harness.host_ms(e2e, dev)[1] for _ in range(reps)]))
        share = t_enc / (t_enc + t_sea)
        report[b] = dict(L=length, tq=tq, p=p_t, tok_ms=t_tok, enc_ms=t_enc, search_ms=t_sea,
                         e2e_ms=t_e2e, e2e_qps=b / (t_e2e / 1e3), encode_share=share)
        print(f"B={b:5d} L={length} tq={tq:4d} p={p_t}: tokenize {t_tok:7.2f} ms  "
              f"encode {t_enc:7.2f} ms  search {t_sea:7.2f} ms  e2e {t_e2e:7.2f} ms "
              f"({b / (t_e2e / 1e3):,.0f} q/s; encode share {share * 100:.0f}% of card work)",
              flush=True)
    return harness.emit({"script": "bench_text_serving", "card": card, "N": n, "nlist": NLIST,
                         "build_s": build_s, "n_tiles": n_tiles,
                         "B": {str(b): r for b, r in report.items()},
                         "launches": harness.launches()})


if __name__ == "__main__":
    main()
