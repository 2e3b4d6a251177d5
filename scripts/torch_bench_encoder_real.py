"""Encoder-real geometry (counterpart of scripts/bench_encoder_real.py).

The headline numbers come from one synthetic Gaussian generator (32-d
latent, 256 soft clusters). Real encoder output has another intrinsic
dimension and anisotropy, so this script checks the index on embeddings the
encoder produced, end to end and offline:

  1. n synthetic-text passages (8 topics x high-entropy entity and number
     tokens: no two alike);
  2. a WordPiece tokenizer (vocab 8192) and the MiniLM-L6-class encoder at
     max_len 48, trained on in-batch triplets mined from the corpus (the
     pipeline's stages), with the Wang-Isola uniformity term (UNIF, 1.0);
  3. every passage encoded on the card (streaming, embeddings kept there);
  4. the residual-int8 tiles index (nlist 4096, 384-d) built on them, tuned
     against the exact top-10 (``tune(..., gt=)``), then recall@10 of
     truncated-passage queries against the exact top-10 and the tuner's QPS;
     the witness: recall at full tile coverage through K1, and the exact
     search over the index's own int8 rows (which of the op point and the
     geometry holds recall back);
  5. config #2's shape: an IVF-Flat nprobe sweep on the first 200k rows.

It also prints the geometry (mean pairwise cosine, participation-ratio
intrinsic dimension) beside the Gaussian generator's. ``gen_passages`` and
``geometry_stats`` are the reference's, verbatim. The reference's record:
recall@10 0.9436 at 1M passages, 1500 steps, mean cosine 0.984, intrinsic
dimension 8.0 (ROUND5.md). At max_len 48 the attention is the 'naive' path
(K4 takes L % 128 == 0, or packs 128 / L rows when L divides 128), as in
the reference. Ends with one JSON line.

Usage: python scripts/torch_bench_encoder_real.py [n_passages_M=2] [steps=1500]
Env:   UNIF (1.0)
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cloudvectordb_tpu_torch.data.tokenize import TextTokenizer  # noqa: E402
from cloudvectordb_tpu_torch.data.triplets import mine_triplets, triplet_batches  # noqa: E402
from cloudvectordb_tpu_torch.eval import harness  # noqa: E402
from cloudvectordb_tpu_torch.eval.recall import recall_at_k  # noqa: E402
from cloudvectordb_tpu_torch.eval.sweep import nprobe_sweep  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_flat import IVFFlatIndex  # noqa: E402
from cloudvectordb_tpu_torch.models.embed import encode_corpus_streaming  # noqa: E402
from cloudvectordb_tpu_torch.ops.topk import tiled_topk  # noqa: E402
from cloudvectordb_tpu_torch.train.trainer import Trainer  # noqa: E402
from cloudvectordb_tpu_torch.utils.config import (  # noqa: E402
    EncoderConfig, MiningConfig, TrainConfig)
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

MAX_LEN = 48
VOCAB, TOKENIZER_DOCS = 8192, 100_000
MINE_DOCS, NUM_TRIPLETS = 400_000, 60_000
TRAIN_BATCH, LR, WARMUP = 256, 5e-4, 100
#: encoder fields beyond the vocabulary and max_len (the MiniLM-L6 defaults)
ENCODER: dict = {}
ENCODE_BATCH, CHUNK_ROWS, HOST_ROWS = 512, 250_000, 200_000
B, NQ_GT, K = 4096, 512, 10
NLIST, IVF_NLIST = 4096, 1024
NPROBES = (4, 16, 64, 256)
#: the reference's record at 1M passages (ROUND5.md:24)
REFERENCE = {"recall": 0.9436, "mean_cos": 0.984, "intrinsic_dim": 8.0}


TOPICS = [
    ("astronomy", "telescope galaxy orbit nebula supernova planet quasar "
     "asteroid spectrum redshift".split()),
    ("cooking", "recipe oven saute flavor ingredient simmer braise whisk "
     "marinade glaze".split()),
    ("finance", "market equity dividend portfolio interest bond futures "
     "hedge yield liquidity".split()),
    ("biology", "cell protein genome enzyme membrane organism mitosis "
     "receptor plasmid ribosome".split()),
    ("music", "melody rhythm chord orchestra tempo harmony cadence "
     "counterpoint timbre sonata".split()),
    ("sports", "tournament goal athlete league stadium coach playoff "
     "sprint defense referee".split()),
    ("computing", "compiler kernel network algorithm memory cache thread "
     "scheduler register pipeline".split()),
    ("geography", "river mountain climate desert coast valley plateau "
     "glacier estuary basin".split()),
]


def gen_passages(n: int, seed: int = 0) -> tuple[list[str], list[int]]:
    """High-entropy topical passages: topic words carry the semantics
    (retrieval signal), entity/number tokens make every passage distinct."""
    rng = np.random.default_rng(seed)
    t_idx = rng.integers(0, len(TOPICS), n)
    w_idx = rng.integers(0, 10, (n, 6))
    ents = rng.integers(0, 100_000, (n, 2))
    out = []
    for i in range(n):
        tname, words = TOPICS[t_idx[i]]
        w = [words[j] for j in w_idx[i]]
        out.append(
            f"report {ents[i,0]} on {tname}: the {w[0]} and the {w[1]} "
            f"shape the {w[2]} near {w[3]} while {w[4]} entry {ents[i,1]} "
            f"records the {w[5]}"
        )
    return out, t_idx.tolist()


def geometry_stats(emb: np.ndarray) -> tuple[float, float]:
    """(mean pairwise cosine, participation-ratio intrinsic dim)."""
    x = emb[:4096].astype(np.float64)
    x = x / np.linalg.norm(x, axis=1, keepdims=True)
    cos = float((x @ x.T).mean())
    xc = x - x.mean(0)
    ev = np.linalg.eigvalsh(xc.T @ xc / x.shape[0])
    pr = float(ev.sum() ** 2 / (ev ** 2).sum())
    return cos, pr


def main(argv=None, device="cuda") -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = as_device(device)
    n = int((float(argv[0]) if argv else 2.0) * 1e6)
    steps = int(argv[1]) if len(argv) > 1 else 1500
    unif = float(os.environ.get("UNIF", "1.0"))
    card = harness.card_line(dev)
    print(f"encoder-real: {n} passages, {steps} steps, uniformity {unif}; {card}", flush=True)
    harness.reset_launches()
    t0 = time.perf_counter()
    passages, doc_ids = gen_passages(n, seed=11)
    print(f"[corpus] {n} passages in {time.perf_counter() - t0:.0f} s", flush=True)

    t0 = time.perf_counter()
    tok = TextTokenizer.train(passages[:TOKENIZER_DOCS], vocab_size=VOCAB, max_len=MAX_LEN)
    tok_s = time.perf_counter() - t0
    print(f"[tokenizer] vocab {tok.vocab_size} in {tok_s:.0f} s", flush=True)

    # -- train the encoder on in-batch triplets (the pipeline's path) ----------
    trip = mine_triplets(passages[:MINE_DOCS], doc_ids[:MINE_DOCS],
                         MiningConfig(strategy="inbatch", num_triplets=NUM_TRIPLETS, seed=3))
    ecfg = EncoderConfig(vocab_size=max(tok.vocab_size, 8), max_len=MAX_LEN, **ENCODER)
    with tempfile.TemporaryDirectory() as ckpt:
        tcfg = TrainConfig(encoder=ecfg, batch_size=TRAIN_BATCH, total_steps=steps, lr=LR,
                           warmup_steps=WARMUP, ckpt_every=10 ** 9, uniformity_weight=unif,
                           ckpt_dir=ckpt)
        trainer = Trainer(tcfg, device=dev)
        state, train_ms = harness.host_ms(lambda: trainer.fit(
            triplet_batches(trip, tok, tcfg.batch_size, MAX_LEN, seed=0), resume=False), dev)
    model = state.model
    train_launches = harness.launches()
    print(f"[train] {steps} steps (B={tcfg.batch_size}, L={MAX_LEN}) in {train_ms / 1e3:.0f} s",
          flush=True)

    # -- encode the corpus on the card; the embeddings stay there --------------
    chunks, blocks, head = [], [], []

    def consume(block):
        blocks.append(block)
        if sum(h.shape[0] for h in head) < HOST_ROWS:
            head.append(block.cpu().numpy())
        if sum(b.shape[0] for b in blocks) >= CHUNK_ROWS:
            chunks.append(torch.cat(blocks))
            blocks.clear()

    total, enc_ms = harness.host_ms(lambda: encode_corpus_streaming(
        model, tok, passages, consume, batch_size=ENCODE_BATCH, max_len=MAX_LEN, device=dev),
        dev)
    if blocks:
        chunks.append(torch.cat(blocks))
        blocks.clear()
    enc_s = enc_ms / 1e3
    print(f"[encode] {total} passages in {enc_s:.0f} s ({total / enc_s:,.0f}/s with the host's "
          f"tokenizer)", flush=True)
    cos, pr = geometry_stats(chunks[0][:4096].cpu().numpy())
    print(f"[geometry] mean-cos {cos:.3f}, participation-ratio intrinsic dim {pr:.1f} "
          f"(Gaussian generator: ~0.00, ~32; the reference at 1M: "
          f"{REFERENCE['mean_cos']}, {REFERENCE['intrinsic_dim']})", flush=True)

    # -- queries: truncated passages; the exact top-10 over every chunk --------
    rng = np.random.default_rng(99)
    q_src = rng.integers(0, n, B)
    q_text = [" ".join(passages[i].split()[:7]) for i in q_src]
    q_emb = []
    encode_corpus_streaming(model, tok, q_text, q_emb.append, batch_size=ENCODE_BATCH,
                            max_len=MAX_LEN, device=dev)
    q = torch.cat(q_emb)
    (gv, gt), gt_ms = harness.host_ms(
        lambda: harness.exact_topk_chunks(lambda i: chunks[i], len(chunks), q, K), dev)
    gv, gt = gv.cpu().numpy(), gt.cpu().numpy()
    gaps = {"top1_top2": float(np.median(gv[:, 0] - gv[:, 1])),
            "top9_top10": float(np.median(gv[:, -2] - gv[:, -1]))}
    print(f"[gt] {gt_ms / 1e3:.0f} s; IP gaps: top1-top2 median {gaps['top1_top2']:.2e}, "
          f"top9-top10 {gaps['top9_top10']:.2e}", flush=True)

    # -- the residual-int8 tiles index on the encoder's output -----------------
    idx, build_ms = harness.host_ms(lambda: BandIVFIndex.build_device_streaming(
        lambda i: chunks[i], len(chunks), nlist=NLIST, kmeans_iters=10, residual=True,
        device=dev), dev)
    print(f"[build] tiles index in {build_ms / 1e3:.0f} s", flush=True)
    q_np = q.cpu().numpy()
    report = idx.tune(q_np, k=K, target_recall=0.95, gt=gt, verbose=True)
    s_op, found = idx.search(q_np, K)
    r_abs = recall_at_k(found[:NQ_GT], gt[:NQ_GT])
    print(f"[tiles] tuned op {report['op']} (exact recall {report['recall']:.4f} on {B} "
          f"queries, met={report['met']}): recall@10={r_abs:.4f} on the first {NQ_GT}  "
          f"{report['qps']:,.0f} qps (host clock over search())", flush=True)

    # -- the witness: the op point or the geometry? ----------------------------
    full = idx._tune_n_tiles()
    _, i_full = idx.search(q_np[:NQ_GT], K, p_tiles=full)
    x = torch.cat(chunks)
    rows = torch.from_numpy(idx.reconstruct(np.arange(x.shape[0]))).to(dev)
    qg = q[:NQ_GT]
    witness = {"op": r_abs, "full_coverage": recall_at_k(i_full, gt[:NQ_GT]),
               "int8_rows_exact": recall_at_k(tiled_topk(rows, qg, K)[1].cpu().numpy(),
                                              gt[:NQ_GT])}
    g = torch.from_numpy(gt[:NQ_GT]).to(dev)
    s_true = (x[g] * qg[:, None]).sum(-1)
    witness["spread"] = float((s_true[:, 0] - s_true[:, -1]).median())
    witness["int8_err"] = float(((rows[g] * qg[:, None]).sum(-1) - s_true).abs().median())
    del rows, x
    print(f"[witness] recall@10 at the op point {witness['op']:.4f}, at full tile coverage "
          f"{witness['full_coverage']:.4f}, exact over the int8 rows "
          f"{witness['int8_rows_exact']:.4f}; the true top-10's score spread "
          f"{witness['spread']:.3g} (median) against the int8 rows' score error "
          f"{witness['int8_err']:.3g}; the reference's record {REFERENCE['recall']}",
          flush=True)

    # -- config #2's shape: IVF-Flat on the first 200k rows ----------------------
    sub = np.concatenate(head)[:HOST_ROWS]
    t0 = time.perf_counter()
    ivf = IVFFlatIndex.build(sub, nlist=IVF_NLIST, kmeans_iters=8, seed=0, device=dev)
    print(f"[ivf_flat] {sub.shape[0]} build {time.perf_counter() - t0:.0f} s", flush=True)
    sweep = nprobe_sweep(ivf, sub, q_np[:NQ_GT], k=K, nprobes=NPROBES)
    for row in sweep:
        print(f"[ivf_flat] nprobe={row['nprobe']:4d}: recall@10={row['recall']:.4f}  "
              f"{row['qps']:8.0f} qps", flush=True)
    return harness.emit({
        "script": "bench_encoder_real", "card": card, "passages": n, "steps": steps,
        "uniformity": unif, "tokenizer_s": tok_s, "train_s": train_ms / 1e3,
        "train_ms_step": train_ms / max(steps, 1), "encode_s": enc_s,
        "encode_per_s": total / enc_s, "mean_cos": cos, "intrinsic_dim": pr, "ip_gaps": gaps,
        "build_s": build_ms / 1e3, "op": report["op"], "tune_recall": report["recall"],
        "met": report["met"], "recall": r_abs, "qps": report["qps"], "witness": witness,
        "ivf_flat": sweep, "reference": REFERENCE, "train_launches": train_launches,
        "launches": harness.launches()})


if __name__ == "__main__":
    main()
