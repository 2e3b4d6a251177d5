"""Config #4's per-card share (counterpart of scripts/bench_scale.py): an
N x 768 int8 tiles index built on the device by streaming, its exact ground
truth streamed, then a p_tiles sweep of recall@10 and fenced QPS against
the 6,250 QPS a card of the 50,000 QPS target (100M rows over 8 cards).

Usage: python scripts/torch_bench_scale.py [N_millions=12.5] [nlist=4096]
           [p_list=128,256,512,768,1024] [modes]
Env:   BENCH_CHUNK=500000, BENCH_RESID=1 (0: whole rows)

The data is bench.py's process (``harness.latent_corpus``: a 32-d latent,
256 unit centres, unit rows), chunks of BENCH_CHUNK with a partial last
one; the queries are noisy copies of chunk 0's rows. The ground truth is
the exact f32 top-10 of the first 512 of the 4096 queries over every chunk.
The build is ``build_device_streaming``, residual unless BENCH_RESID=0.
The modes default to ``resid`` (one ``_tiles_resid_plan_search`` dispatch,
K1) on a residual arena, else ``hybrid,int8`` (``_tiles_plan_search`` on
whole rows, K3, bf16 or int8 queries). p is clamped to the arena's tiles;
each row takes 2 warm calls, then 16 fenced calls on queries moved by a
small constant. Ends with the reference's summary and one JSON line.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cloudvectordb_tpu_torch.eval import harness  # noqa: E402
from cloudvectordb_tpu_torch.eval.recall import recall_at_k  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_band import (  # noqa: E402
    BandIVFIndex, _tiles_plan_search, _tiles_resid_plan_search)
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

D, K, B = 768, 10, 4096
NQ_GT = 512  # queries with exact ground truth (recall measurement)
REPS = 16
#: a card's share of the 50,000 QPS target over 8 cards
SHARE_QPS = 6250


def clamp_p(p_tiles: int, n_tiles: int) -> int:
    """The reference's clamp of a swept p_tiles to the arena's tiles."""
    return min(p_tiles, n_tiles)


def share(qps: float) -> float:
    """QPS as a multiple of a card's share of the target."""
    return qps / SHARE_QPS


def main(argv=None, device="cuda") -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = as_device(device)
    chunk = int(os.environ.get("BENCH_CHUNK", 500_000))
    n = int((float(argv[0]) if argv else 12.5) * 1e6)
    nlist = int(argv[1]) if len(argv) > 1 else 4096
    sizes = harness.chunk_sizes(n, chunk)
    card = harness.card_line(dev)
    print(f"N={n} D={D} nlist={nlist} chunks={len(sizes)}; {card}", flush=True)
    chunk_fn = harness.latent_corpus(dev, D, sizes)
    queries = harness.noisy_queries(chunk_fn(0), B)
    harness.reset_launches()

    (_, gt), gt_ms = harness.host_ms(
        lambda: harness.exact_topk_chunks(chunk_fn, len(sizes), queries[:NQ_GT], K), dev)
    gt = gt.cpu().numpy()
    print(f"ground truth: {gt_ms / 1e3:.0f} s", flush=True)

    residual = os.environ.get("BENCH_RESID", "1") == "1"
    t0 = time.perf_counter()
    idx = BandIVFIndex.build_device_streaming(chunk_fn, len(sizes), nlist=nlist,
                                              kmeans_iters=10, residual=residual, device=dev)
    harness.sync(dev)
    build_s = time.perf_counter() - t0
    n_tiles = int(idx._payload.shape[0]) // idx.tile_n
    print(f"build (device-streaming): {build_s:.0f} s, n_tiles={n_tiles}", flush=True)

    st = idx._device_state()
    modes = argv[3].split(",") if len(argv) > 3 else (
        ["resid"] if residual else ["hybrid", "int8"])
    p_list = [int(x) for x in (argv[2].split(",") if len(argv) > 2
                               else ["128", "256", "512", "768", "1024"])]
    results = []
    for mode in modes:
        int8_mode = "hybrid" if mode == "hybrid" else True
        for p_tiles in p_list:
            p_tiles = clamp_p(p_tiles, n_tiles)
            if mode == "resid":
                def run(noise, p_tiles=p_tiles):
                    return _tiles_resid_plan_search(
                        queries + noise, st["centroids"], st["payload"], st["local"],
                        st["centroid_tiles"], idx._scale, st["ids"], st["tile_window"],
                        st["valid_end"], k=K, p_tiles=p_tiles, tile_n=idx.tile_n,
                        tile_q=idx.tile_q)
            else:
                def run(noise, p_tiles=p_tiles, int8_mode=int8_mode):
                    return _tiles_plan_search(
                        queries + noise, st["centroids"], st["payload"], st["ids"],
                        st["tile_window"], idx._scale, idx._n, k=K, p_tiles=p_tiles,
                        tile_n=idx.tile_n, tile_q=idx.tile_q, int8=int8_mode)

            _, g = run(0.0)  # builds the kernel
            r = recall_at_k(g[:NQ_GT].cpu().numpy(), gt)
            for it in range(2):  # warm
                run(0.5 + 1e-4 * it)
            _, ms = harness.host_ms(lambda: [run(1e-4 * (it + 1)) for it in range(REPS)], dev)
            qps = B * REPS / (ms / 1e3)
            cov = p_tiles / n_tiles
            print(f"{mode:6s} p_tiles={p_tiles:5d} ({cov:5.1%}): recall@10={r:.4f}  "
                  f"{qps:9.0f} qps/card ({share(qps):.1f}x share)", flush=True)
            results.append({"mode": mode, "p_tiles": p_tiles, "coverage": cov, "recall": r,
                            "ms": ms / REPS, "qps": qps, "share": share(qps)})

    print("\nsummary", flush=True)
    for row in results:
        print(f"  {row['mode']:6s} {row['p_tiles']:5d} {row['coverage']:5.1%} "
              f"{row['recall']:.4f} {row['qps']:9.0f}", flush=True)
    print(f"build_wallclock_s={build_s:.0f}", flush=True)
    return harness.emit({"script": "bench_scale", "card": card, "N": n, "nlist": nlist,
                         "residual": residual, "gt_s": gt_ms / 1e3, "build_s": build_s,
                         "n_tiles": n_tiles, "rows": results, "launches": harness.launches()})


if __name__ == "__main__":
    main()
