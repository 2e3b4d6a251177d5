"""BASELINE config #5's share of one card: 1B / 8 = 125M x 768 OPQ + IVF-PQ
(m 64), a device-resident streaming build, then incremental adds
(counterpart of scripts/bench_config5.py).

Usage: python scripts/torch_bench_config5.py [N_millions=125] [nlist=16384] [p_tiles=4096,8192]
Env:   REFINE=pq2|none|host (pq2), M2=32, ANISO_ETA, BENCH_TILE_N=1024,
       BENCH_CHUNK=250000, TOP2=1, ATTACH_HOST=1, CASC="rf:hf:top2,...", HOST_P

The PQ codes of 125M rows (8 GB) are built and served on the card.
refine='pq2' adds a tier-2 PQ on the card (m2 bytes a row) trained on the
tier-1 reconstruction error: the kernel's candidates (K5) are re-ranked by
the tier-1 score plus the tier-2 correction. refine='host' keeps int8
residual rows in host memory for an exact rescore; ATTACH_HOST=1 attaches
that tier to a 'pq2' or 'none' build (a 'pq2' build becomes the 'pq2+host'
cascade: the tier-2 table narrows the candidates on the card, and only
k·host_factor rows a query are gathered from host memory). 125M host int8
rows are 96 GB, more than a one-card machine holds, so the host tier runs
at a smaller N.

For each p_tiles: the tier-1 ranking alone (K5, no rescore), and with
'pq2' the candidate recall at two budgets (the exact-rescore ceiling of a
host tier) and the pq2 route at refine_factor 102, 205 and 410. Recall is
against the exact f32 top-10 of 512 queries over the streamed corpus;
QPS is B=4096 over CUDA events around ``search_device`` (the host tier's
``search()`` by the fenced host clock). Ends with one JSON line.
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
from cloudvectordb_tpu_torch.index.ivf_band_pq import BandIVFPQIndex  # noqa: E402
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

D, K, B = 768, 10, 4096
NQ_GT = 512
M, NBITS = 64, 8
REPS = 4
#: (k_cand, pools, top2) of the candidate ceilings; TOP2=1 adds the top-2 rows
CEILINGS = ((1024, 2, False), (4096, 4, False))
CEILINGS_TOP2 = ((2048, 2, True), (8192, 4, True))
#: (refine_factor, pools, tile_q) of the pq2 route
PQ2_PLANS = ((102, 2, 128), (205, 4, 128), (410, 4, 128))
#: the host tier's batch and (refine_factor, host_factor or None, top2) plans
HOST_B = 512
CASCADE = ((410, 410, False), (410, 64, False), (820, 64, False), (820, 102, False))
HOST_ONLY = ((64, None, False), (102, None, False), (410, None, False))
ADDS = 8192


def tier1(idx, qr, k: int, kc: int, n_pools: int, tq: int, p: int, top2: bool = False):
    """K5's top-k of kc candidates by their tier-1 scores (no rescore), in
    n_pools pools of kc / n_pools slots (halved with top-2: two a bucket), as
    the reference passes them; kc = k takes the kernel's default buckets."""
    return harness.pq_tier1(idx, qr, k=k, k_cand=kc, n_pools=n_pools,
                            l_buckets=0 if kc == k else kc // n_pools // (2 if top2 else 1),
                            tile_q=tq, p_tiles=p, top2=top2)


def device_qps(fn, q: torch.Tensor, dev) -> tuple[float, float]:
    """(median ms of REPS calls of fn on distinct inputs, QPS), after a warm-up."""
    fn(q + 0.5)
    ms = float(np.median(harness.device_ms(lambda i: fn(q + 1e-4 * (i + 1)), dev, REPS)))
    return ms, q.shape[0] / (ms / 1e3)


def resident_gb(idx) -> dict:
    """GB of each tensor of the index's device state and tier stores."""
    parts = dict(idx._device_state())
    parts["codes2"] = idx._codes2
    out = {}
    for name, t in parts.items():
        if isinstance(t, torch.Tensor):
            out[name] = t.numel() * t.element_size() / 1e9
    return out


def main(argv=None, device="cuda") -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = as_device(device)
    n = int(float(argv[0]) * 1e6) if argv else 125_000_000
    nlist = int(argv[1]) if len(argv) > 1 else 16384
    p_list = [int(x) for x in (argv[2].split(",") if len(argv) > 2 else ["4096", "8192"])]
    chunk = int(os.environ.get("BENCH_CHUNK", 250_000))
    aniso_eta = float(os.environ.get("ANISO_ETA", "0"))
    tile_n = int(os.environ.get("BENCH_TILE_N", "1024"))
    refine = os.environ.get("REFINE", "pq2")
    m2 = int(os.environ.get("M2", "32"))
    card = harness.card_line(dev)
    sizes = harness.chunk_sizes(n, chunk)
    print(f"config#5 slice: N={n} D={D} m={M} nbits={NBITS} OPQ refine={refine} m2={m2} "
          f"nlist={nlist} chunks={len(sizes)} aniso_eta={aniso_eta}; {card}", flush=True)
    chunk_fn = harness.latent_corpus(dev, D, sizes)
    queries = harness.noisy_queries(chunk_fn(0), B)
    q_gt = queries[:NQ_GT]
    harness.reset_launches()

    # --- exact ground truth -------------------------------------------------------
    (_, gt), gt_ms = harness.host_ms(
        lambda: harness.exact_topk_chunks(chunk_fn, len(sizes), q_gt, K), dev)
    gt = gt.cpu().numpy()
    print(f"[gt] {gt_ms / 1e3:.0f} s", flush=True)

    # --- the device-resident OPQ + IVF-PQ build --------------------------------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    idx, build_ms = harness.host_ms(lambda: BandIVFPQIndex.build_device_streaming(
        chunk_fn, len(sizes), nlist=nlist, m=M, nbits=NBITS, opq=True, refine=refine,
        kmeans_iters=8, pq_train_iters=6, aniso_eta=aniso_eta, tile_n=tile_n, m2=m2,
        device=dev), dev)
    build_s = build_ms / 1e3
    n_tiles = idx._tune_n_tiles()
    gb = resident_gb(idx)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    print(f"[build] {build_s:.0f} s; n_tiles={n_tiles}; on the card: "
          + "  ".join(f"{k}={v:.2f}GB" for k, v in sorted(gb.items(), key=lambda kv: -kv[1])
                      if v >= 0.01)
          + f"  total={sum(gb.values()):.2f}GB; peak allocated {peak:.2f} GB", flush=True)

    qr = idx._rotate(queries)
    qn = queries.cpu().numpy()
    evals = []
    for p_tiles in p_list:
        p = min(p_tiles, n_tiles)
        _, g = tier1(idx, qr, K, K, 1, idx.tile_q, p)
        r = recall_at_k(g[:NQ_GT].cpu().numpy(), gt)
        ms, qps = device_qps(lambda q: tier1(idx, idx._rotate(q), K, K, 1, idx.tile_q, p),
                             queries, dev)
        evals.append({"route": "tier1", "p": p, "share": p / n_tiles, "recall": r, "ms": ms,
                      "qps": qps})
        print(f"[eval] tier1-only p_tiles={p:6d} ({p / n_tiles:5.1%}): recall@10={r:.4f}  "
              f"{qps:8.0f} qps", flush=True)
        if refine != "pq2":
            continue
        # the candidate recall: the exact-rescore ceiling of a host tier here
        cfgs = CEILINGS + (CEILINGS_TOP2 if os.environ.get("TOP2") == "1" else ())
        for kc, npool, top2 in cfgs:
            gc = tier1(idx, qr[:NQ_GT], kc, kc, npool, 64, p, top2)[1].cpu().numpy()
            crec = float(np.mean([len(set(gc[i]) & set(gt[i])) / K for i in range(NQ_GT)]))
            evals.append({"route": "ceiling", "p": p, "k_cand": kc, "pools": npool,
                          "top2": top2, "recall": crec})
            print(f"[eval] host-ceiling p={p} k_cand={kc} pools={npool} top2={int(top2)}: "
                  f"candidate-recall@10={crec:.4f}", flush=True)
        for rf, npool, tq2 in PQ2_PLANS:
            kw = dict(p_tiles=p, refine_factor=rf, n_pools=npool, tile_q=tq2)
            # the whole batch, as served: a query group's tile table spans
            # its queries' lists, so a smaller batch needs more tiles
            _, g2 = idx.search(qn, K, **kw)
            r2 = recall_at_k(g2[:NQ_GT], gt)
            ms, qps = device_qps(lambda q: idx.search_device(q, K, **kw), queries, dev)
            evals.append({"route": "pq2", "p": p, "k_cand": rf * K, "pools": npool, "tq": tq2,
                          "recall": r2, "ms": ms, "qps": qps})
            print(f"[eval] pq2 p={p} k_cand={rf * K} pools={npool} tq={tq2}: "
                  f"recall@10={r2:.4f}  {qps:8.0f} qps", flush=True)

    # --- the host exact-rescore tier (ATTACH_HOST=1) -----------------------------------
    host = []
    attach_s = None
    if os.environ.get("ATTACH_HOST") == "1" and refine in ("pq2", "none"):
        # rows made on the card straight in the rotated space, copied to the host
        rot_fn = harness.latent_corpus(dev, D, sizes,
                                       rotation=torch.as_tensor(idx.opq_matrix))
        _, attach_ms = harness.host_ms(lambda: idx.attach_host_refine(
            lambda i: rot_fn(i).cpu().numpy(), len(sizes), chunks_rotated=True), dev)
        attach_s = attach_ms / 1e3
        print(f"[attach] host tier ({idx._host_rows.nbytes / 1e9:.1f} GB of host memory) in "
              f"{attach_s:.0f} s; refine={idx.refine!r}", flush=True)
        cascade = idx.refine == "pq2+host"
        cfgs = list(CASCADE if cascade else HOST_ONLY)
        if os.environ.get("TOP2") == "1":
            cfgs += ([(410, 64, True), (820, 102, True)] if cascade
                     else [(205, None, True), (410, None, True)])
        if os.environ.get("CASC"):
            cfgs = []
            for spec in os.environ["CASC"].split(","):
                rf, hf, t2 = spec.split(":")
                cfgs.append((int(rf), int(hf) or None, t2 == "1"))
        p_h = min(int(os.environ.get("HOST_P", p_list[-1])), n_tiles)
        bq = min(HOST_B, NQ_GT)
        for rf, hf, top2 in cfgs:
            kw = dict(p_tiles=p_h, refine_factor=rf, tile_q=64, top2=top2,
                      **({"host_factor": hf} if hf is not None else {}))
            _, gh = idx.search(qn[:bq], K, **kw)
            rh = recall_at_k(gh, gt[:bq])
            _, ms = harness.host_ms(lambda: idx.search(np.roll(qn[:bq], 1, axis=0), K, **kw),
                                    dev)
            k_ship = min(hf or rf, rf) * K
            host.append({"p": p_h, "B": bq, "k_cand": rf * K, "k_host": k_ship, "top2": top2,
                         "recall": rh, "ms": ms, "qps": bq / (ms / 1e3),
                         "gathered_gb": bq * k_ship * D / 1e9})
            print(f"[eval] {'cascade' if cascade and hf else 'host-tier'} p={p_h} B={bq} "
                  f"k_cand={rf * K} k_host={k_ship} top2={int(top2)}: recall@10={rh:.4f}  "
                  f"{bq / (ms / 1e3):6.0f} qps (gathers {bq * k_ship * D / 1e9:.3f} GB of host "
                  f"int8 a batch)", flush=True)

    # --- incremental updates (a config #5 requirement) ------------------------------------
    extra = harness.latent_corpus(dev, D, {999_999: ADDS})(999_999)
    _, add_ms = harness.host_ms(lambda: idx.add(extra), dev)
    _, found = idx.search(extra[:64].cpu().numpy(), 1, p_tiles=min(2048, n_tiles))
    hit = float((found[:, 0] >= n).mean())
    print(f"[add] {ADDS} rows in {add_ms / 1e3:.1f} s (pending-scan path); self-retrieval of "
          f"added rows: {hit:.2f}", flush=True)
    print(f"build_wallclock_s={build_s:.0f}", flush=True)
    return harness.emit({"script": "bench_config5", "card": card, "N": n, "nlist": nlist,
                         "refine": idx.refine, "m2": m2, "tile_n": idx.tile_n,
                         "n_tiles": n_tiles, "gt_s": gt_ms / 1e3, "build_s": build_s,
                         "resident_gb": gb, "peak_gb": peak, "eval": evals,
                         "attach_s": attach_s, "host": host, "add_s": add_ms / 1e3,
                         "add_self_hit": hit, "launches": harness.launches()})


if __name__ == "__main__":
    main()
