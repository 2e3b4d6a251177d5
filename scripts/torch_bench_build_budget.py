"""Config #3 (10M x 768 OPQ + IVF-PQ m 64, int8 refine) build and the
one-hour full-build budget (counterpart of scripts/bench_build_budget.py).

Usage: python scripts/torch_bench_build_budget.py [N_millions=10] [p:k_cand:pools:tile_q[:top2],...]
Env:   BENCH_CHUNK=500000, BENCH_NLIST=4096, ANISO_ETA=0, RF_CFGS="0:64,512:64,768:64"

Times each stage of "a full build from raw text" (BASELINE.json) at the
size one card holds, then projects it onto BASELINE config #4's share of a
card (12.5M rows) against the one-hour budget:

  1. encode   MiniLM-L6-class forward throughput (B 512, L 128, bf16): the
              pipeline streams tokenize (host), encode (card), insert
              (card), so encoding takes rows / throughput;
  2. train    OPQ rotation, coarse k-means (nlist) and the PQ codebooks on
              the first chunk's 262,144-row sample, each timed on its own
              (the reference timed them inside the populate); constant in N;
  3. populate assign, rotate, residual-PQ encode, int8 refine quantize and
              scatter, all on the card (``build_device_streaming`` given
              the stage-2 quantizers);
  4. eval     exact top-128 of 512 queries; the refine route (K1 over the
              refine rows) and the PQ route (K5 with the int8 rescore) at
              each configuration, recall@10 and device QPS from CUDA events;
              ``[decomp]``: the int8 rescore of the exact top-128 (the refine
              ceiling), K5's candidate recall and its ranking alone.

The projection: stages 1 and 3 scale with rows a card, stage 2 does not.
It is this card's arithmetic, labelled a projection. Ends with one JSON line.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cloudvectordb_tpu_torch.eval import harness  # noqa: E402
from cloudvectordb_tpu_torch.eval.recall import recall_at_k  # noqa: E402
from cloudvectordb_tpu_torch.index import ivf_band  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_band_pq import (  # noqa: E402
    BandIVFPQIndex, pq_candidate_budget)
from cloudvectordb_tpu_torch.models.encoder import init_encoder  # noqa: E402
from cloudvectordb_tpu_torch.ops.topk import f32_const  # noqa: E402
from cloudvectordb_tpu_torch.utils.config import EncoderConfig  # noqa: E402
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

D, K, B = 768, 10, 4096
NQ_GT = 512
K_CEIL = 128
TRAIN_SAMPLE = 262_144
M, NBITS = 64, 8
#: the encode probe: batches of ENC_B passages of ENC_L tokens
ENC_B, ENC_L, ENC_ITERS = 512, 128, 6
#: BASELINE config #4: 100M rows over 8 cards, the one-hour budget
SHARE_ROWS, BUDGET_S = 100e6 / 8, 3600.0
REPS = 8
DECOMP = ((1024, 1, 128, False), (4096, 4, 64, False), (1024, 1, 128, True),
          (4096, 4, 64, True))


def encode_probe(dev, encoder: EncoderConfig) -> float:
    """Passages a second of the forward (no gradients), after one warm-up
    batch: CUDA events over ENC_ITERS batches on the card."""
    model = init_encoder(encoder, seed=0, device=dev).eval()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    batches = [torch.randint(0, encoder.vocab_size, (ENC_B, encoder.max_len), generator=g,
                             device=dev) for _ in range(8)]
    mask = torch.ones_like(batches[0])
    with torch.inference_mode():
        model(batches[0], mask)
        ms = harness.device_ms(lambda i: model(batches[i % 8], mask), dev, ENC_ITERS)
    return ENC_B * ENC_ITERS / (sum(ms) / 1e3)


def projection(enc_ps: float, train_s: float, populate_s: float, n: int) -> dict:
    """Stages 1 and 3 scaled to a card's share of config #4, stage 2 as
    measured: (seconds of each, the total, whether it meets the budget)."""
    enc = SHARE_ROWS / enc_ps
    pop = populate_s * (SHARE_ROWS / n)
    total = enc + train_s + pop
    return {"rows": SHARE_ROWS, "encode_s": enc, "train_s": train_s, "populate_s": pop,
            "total_s": total, "meets_budget": total < BUDGET_S}


def train_stage(dev, sample: torch.Tensor, nlist: int, aniso_eta: float) -> tuple:
    """OPQ, coarse k-means and PQ codebooks on ``sample``, each timed
    (fenced host clock): (the empty trained index, {stage: seconds})."""
    proto = BandIVFPQIndex(D, nlist, m=M, nbits=NBITS, refine="int8", kmeans_iters=10,
                           pq_train_iters=8, aniso_eta=aniso_eta, device=dev)
    _, opq_ms = harness.host_ms(lambda: proto._train_opq(sample), dev)
    tr = proto._rotate(sample)
    cents, km_ms = harness.host_ms(lambda: ivf_band.train_ordered_centroids(
        tr, nlist, TRAIN_SAMPLE, proto.kmeans_iters, proto.seed), dev)
    _, pq_ms = harness.host_ms(lambda: proto._train_quantizers(tr, cents, None), dev)
    return proto, {"opq_s": opq_ms / 1e3, "kmeans_s": km_ms / 1e3, "pq_s": pq_ms / 1e3}


def candidates(idx, qr: torch.Tensor, kc: int, n_pools: int, tq: int, p: int, top2: bool,
               k: int | None = None):
    """K5's top-k of kc candidates by their tier-1 scores (no rescore), the
    buckets sized as the reference's (``pq_candidate_budget``)."""
    kc, n_pools, l_buckets = pq_candidate_budget(kc, 1, n_pools, tq, p, top2, two_stage=True,
                                                 n=idx._n, tile_n=idx.tile_n)
    return kc, harness.pq_tier1(idx, qr, k=k or kc, k_cand=kc, n_pools=n_pools,
                                l_buckets=l_buckets, tile_q=tq, p_tiles=p, top2=top2)[1]


def refine_ceiling(idx, qr: torch.Tensor, gt128: np.ndarray, gt: np.ndarray) -> float:
    """recall@10 of the int8 rescore of the exact top-128: the best any
    candidate generator could give the refine tier."""
    st = idx._device_state()
    n = int(idx._ids.max()) + 1
    inv = np.empty(n, np.int64)
    inv[idx._ids[: idx._n]] = np.arange(idx._n)
    rows = inv[gt128]
    assign = np.searchsorted(idx._offsets, rows, side="right") - 1
    rows_t = torch.as_tensor(rows, device=qr.device)
    r8 = st["refine"][rows_t].float() * f32_const(idx._scale, qr)
    ex = torch.einsum("bd,brd->br", qr, r8) + torch.gather(
        qr @ st["centroids"].T, 1, torch.as_tensor(assign, device=qr.device))
    pos = torch.sort(ex, dim=1, descending=True, stable=True)[1][:, :K].cpu().numpy()
    return recall_at_k(np.take_along_axis(gt128, pos, axis=1), gt)


def main(argv=None, device="cuda") -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = as_device(device)
    n = int(float(argv[0]) * 1e6) if argv else 10_000_000
    chunk = int(os.environ.get("BENCH_CHUNK", 500_000))
    nlist = int(os.environ.get("BENCH_NLIST", 4096))
    aniso_eta = float(os.environ.get("ANISO_ETA", "0"))
    card = harness.card_line(dev)
    print(f"config#3: N={n} D={D} m={M} nbits={NBITS} OPQ refine=int8 nlist={nlist}; {card}",
          flush=True)
    harness.reset_launches()

    # --- stage 1: encode probe ------------------------------------------------
    enc_ps = encode_probe(dev, EncoderConfig(max_len=ENC_L))
    print(f"[encode] {enc_ps:,.0f} passages/s → {n / 1e6:.0f}M rows = "
          f"{n / enc_ps / 60:.1f} min", flush=True)

    sizes = harness.chunk_sizes(n, chunk)
    chunk_fn = harness.latent_corpus(dev, D, sizes)
    queries = harness.noisy_queries(chunk_fn(0), B)
    q_gt = queries[:NQ_GT]

    # --- exact ground truth (top-128: the refine ceiling reads 10..127) -------
    (_, gt128), gt_ms = harness.host_ms(
        lambda: harness.exact_topk_chunks(chunk_fn, len(sizes), q_gt, K_CEIL), dev)
    gt128 = gt128.cpu().numpy()
    gt = gt128[:, :K]
    print(f"[gt] {gt_ms / 1e3:.0f} s (not part of the build)", flush=True)

    # --- stage 2: the quantizers on the first chunk's sample ------------------
    sample = chunk_fn(0)[:TRAIN_SAMPLE]
    proto, train = train_stage(dev, sample, nlist, aniso_eta)
    sample = None
    train_s = sum(train.values())
    print(f"[train] {train_s:.1f} s: OPQ {train['opq_s']:.1f} s, coarse k-means "
          f"{train['kmeans_s']:.1f} s, PQ codebooks {train['pq_s']:.1f} s", flush=True)

    # --- stage 3: populate on the card ------------------------------------------
    idx, pop_ms = harness.host_ms(lambda: BandIVFPQIndex.build_device_streaming(
        chunk_fn, len(sizes), nlist=nlist, m=M, nbits=NBITS, refine="int8", kmeans_iters=10,
        pq_train_iters=8, aniso_eta=aniso_eta, opq_matrix=proto.opq_matrix,
        centroids=proto.centroids, codebooks=proto.codebooks, device=dev), dev)
    populate_s = pop_ms / 1e3
    n_tiles = idx._tune_n_tiles()
    print(f"[populate] {populate_s:.1f} s ({len(sizes)} chunks: assign, encode, scatter); "
          f"{n_tiles} tiles of {idx.tile_n}", flush=True)

    # --- stage 4: recall and device QPS ------------------------------------------
    qr = idx._rotate(queries)
    refine_rows = []
    for spec in os.environ.get("RF_CFGS", "0:64,512:64,768:64").split(","):
        p_rf, tq = (int(x) for x in spec.split(":"))
        p = min(p_rf, n_tiles) if p_rf else idx._auto_p_tiles(B, 32, n_tiles, tile_q=tq)
        kw = dict(p_tiles=p, tile_q=tq, serve_from="refine")
        # the whole batch, as served: a query group's tile table spans its
        # queries' lists, so a smaller batch needs more tiles
        _, f = idx.search(queries.cpu().numpy(), K, **kw)
        r_host = recall_at_k(f[:NQ_GT], gt)
        _, g = idx.search_device(queries, K, **kw)
        r_dev = recall_at_k(g[:NQ_GT].cpu().numpy(), gt)
        idx.search_device(queries + 0.5, K, **kw)
        ms = float(np.median(harness.device_ms(
            lambda i: idx.search_device(queries + 1e-4 * (i + 1), K, **kw), dev, REPS)))
        refine_rows.append({"p": p, "share": p / n_tiles, "tq": tq, "recall": r_host,
                            "recall_device": r_dev, "ms": ms, "qps": B / (ms / 1e3)})
        print(f"[refine-scan] p={p} ({p / n_tiles:5.1%}) tq={tq}: recall@10={r_host:.4f} "
              f"(device path {r_dev:.4f})  {B / (ms / 1e3):9.0f} qps", flush=True)

    decomp = {"refine_ceiling": refine_ceiling(idx, qr[:NQ_GT], gt128, gt)}
    print(f"[decomp] refine ceiling (int8 rescore of exact top-{K_CEIL}): "
          f"recall@10={decomp['refine_ceiling']:.4f}", flush=True)
    decomp["candidates"] = []
    for kc, n_pools, tq, top2 in DECOMP:
        p = idx._auto_p_tiles(B, 32, n_tiles, tile_q=tq)
        kc, g = candidates(idx, qr, kc, n_pools, tq, p, top2)
        cand = g[:NQ_GT].cpu().numpy()
        hit = float(np.mean([np.isin(gt[b], cand[b]) for b in range(NQ_GT)]))
        decomp["candidates"].append({"k_cand": kc, "pools": n_pools, "tq": tq, "p": p,
                                     "top2": top2, "recall": hit})
        print(f"[decomp] PQ candidate recall@{kc} (pools={n_pools} tq={tq} p={p} "
              f"top2={int(top2)}): {hit:.4f}", flush=True)
    _, g10 = candidates(idx, qr, K, 1, 64, idx._auto_p_tiles(B, 32, n_tiles, tile_q=64),
                        False, k=K)
    decomp["pq_only"] = recall_at_k(g10[:NQ_GT].cpu().numpy(), gt)
    print(f"[decomp] PQ-only ranking: recall@10={decomp['pq_only']:.4f}", flush=True)

    pq_rows = []
    for spec in (argv[1].split(",") if len(argv) > 1
                 else ["0:1024:1:128", "0:4096:4:64", "512:4096:4:64"]):
        parts = [int(x) for x in spec.split(":")]
        # missing fields take their defaults by position (the reference pads
        # with [1, tile_q, 0] and so reads a four-field spec as top-2)
        p_tiles, k_cand, n_pools, tq, top2 = parts + [0, 0, 1, idx.tile_q, 0][len(parts):]
        p = min(p_tiles, n_tiles) if p_tiles else idx._auto_p_tiles(B, 32, n_tiles, tile_q=tq)
        kw = dict(p_tiles=p, tile_q=tq, serve_from="pq", refine_factor=max(1, k_cand // K),
                  n_pools=n_pools, top2=bool(top2))
        _, g = idx.search_device(queries, K, **kw)
        r = recall_at_k(g[:NQ_GT].cpu().numpy(), gt)
        idx.search_device(queries + 0.5, K, **kw)
        ms = float(np.median(harness.device_ms(
            lambda i: idx.search_device(queries + 1e-4 * (i + 1), K, **kw), dev, REPS)))
        pq_rows.append({"p": p, "share": p / n_tiles, "k_cand": k_cand, "pools": n_pools,
                        "tq": tq, "top2": bool(top2), "recall": r, "ms": ms,
                        "qps": B / (ms / 1e3)})
        print(f"[eval] p={p} ({p / n_tiles:5.1%}) k_cand={k_cand} pools={n_pools} tq={tq} "
              f"top2={top2}: recall@10={r:.4f}  {B / (ms / 1e3):9.0f} qps", flush=True)

    # --- the budget, projected onto config #4's share of a card -----------------
    proj = projection(enc_ps, train_s, populate_s, n)
    print(f"\nbuild budget: a projection for {SHARE_ROWS / 1e6:.1f}M rows a card "
          f"(BASELINE config #4, 100M over 8 cards) on this card ({card}):", flush=True)
    print(f"  encode   {proj['encode_s'] / 60:6.1f} min  (measured {enc_ps:,.0f} passages/s, "
          f"linear in rows)", flush=True)
    print(f"  train    {proj['train_s'] / 60:6.1f} min  (measured on the "
          f"{TRAIN_SAMPLE}-row sample, constant)", flush=True)
    print(f"  populate {proj['populate_s'] / 60:6.1f} min  (measured {populate_s:.0f} s for "
          f"{n / 1e6:.0f}M, linear in rows)", flush=True)
    print(f"  TOTAL    {proj['total_s'] / 60:6.1f} min  vs 60 min budget "
          f"({'PASS' if proj['meets_budget'] else 'FAIL'})", flush=True)
    return harness.emit({
        "script": "bench_build_budget", "card": card, "N": n, "nlist": nlist,
        "aniso_eta": aniso_eta, "encode_passages_per_s": enc_ps, "gt_s": gt_ms / 1e3,
        "train": train, "train_s": train_s, "populate_s": populate_s, "n_tiles": n_tiles,
        "refine_scan": refine_rows, "decomp": decomp, "eval": pq_rows, "projection": proj,
        "launches": harness.launches()})


if __name__ == "__main__":
    main()
