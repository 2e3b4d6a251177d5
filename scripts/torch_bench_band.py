"""Whole-row int8 tiles benchmark (counterpart of scripts/bench_band.py):
1M x 768 int8, nlist 1024, against the full int8 scan of the same arena.

Usage: python scripts/torch_bench_band.py

The corpus is the reference's (``harness.direct_corpus``: 256 unit centres,
B 1024 noisy copies of rows), its ground truth the exact f32 top-10. The
index is ``BandIVFIndex.build(dtype='int8')`` on whole rows; each p_tiles
row is one ``_tiles_plan_search`` dispatch with int8 x int8 scoring (K3):
its share of the arena, recall@10 against the exact top-10, and ms and QPS
over 3 fenced calls on queries moved by a small constant, after one call
that builds the kernel. The full int8 scan (K2) is ``flat_topk_int8`` over
the same payload at the arena's scale, timed the same way. Ends with one
JSON line of the rows.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cloudvectordb_tpu_torch.eval import harness  # noqa: E402
from cloudvectordb_tpu_torch.eval.recall import recall_at_k  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex, _tiles_plan_search  # noqa: E402
from cloudvectordb_tpu_torch.ops.flat_topk import flat_topk_int8  # noqa: E402
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

N, D, NLIST, K, B = 1_000_000, 768, 1024, 10, 1024
P_TILES = (16, 32, 64)
ITERS = 3


def main(argv=None, device="cuda") -> dict:
    dev = as_device(device)
    card = harness.card_line(dev)
    print(f"bench_band: N={N} D={D} nlist={NLIST} B={B}; {card}", flush=True)
    x, q = harness.direct_corpus(dev, N, D, B)
    _, gt = harness.exact_topk_chunks(lambda i: x, 1, q, K)
    gt = gt.cpu().numpy()
    print("data ready", flush=True)
    harness.reset_launches()

    t0 = time.perf_counter()
    idx = BandIVFIndex.build(x, nlist=NLIST, dtype="int8", kmeans_iters=10, device=dev)
    harness.sync(dev)
    build_s = time.perf_counter() - t0
    print(f"band build (device-native): {build_s:.0f} s", flush=True)
    x = None

    n_tiles = int(idx._payload.shape[0]) // idx.tile_n
    st = idx._device_state()
    print(f"n_tiles={n_tiles}", flush=True)
    rows = []
    for p_tiles in P_TILES:
        def run(noise, p_tiles=p_tiles):
            return _tiles_plan_search(
                q + noise, st["centroids"], st["payload"], st["ids"], st["tile_window"],
                idx._scale, idx._n, k=K, p_tiles=p_tiles, tile_n=idx.tile_n,
                tile_q=idx.tile_q, int8=True)

        _, g = run(0.0)  # builds the kernel
        r = recall_at_k(g.cpu().numpy(), gt)
        _, ms = harness.host_ms(lambda: [run(1e-4 * (it + 1)) for it in range(ITERS)], dev)
        ms /= ITERS
        rows.append({"p_tiles": p_tiles, "share": p_tiles / n_tiles, "recall": r, "ms": ms,
                     "qps": B / (ms / 1e3)})
        print(f"p_tiles={p_tiles:4d} ({p_tiles / n_tiles:4.0%} of arena): recall@10={r:.4f}  "
              f"{ms:7.1f} ms/batch ({B / (ms / 1e3):7.0f} qps)", flush=True)

    # reference: the full int8 scan of the same store
    payload = st["payload"]

    def full(noise):
        return flat_topk_int8(payload, idx._scale, q + noise, K)

    _, rows_full = full(0.0)
    ids = st["ids"]  # a pad row (score 0) maps to the last id; none reaches the top 10
    r_full = recall_at_k(ids[rows_full.long().clamp(max=ids.shape[0] - 1)].cpu().numpy(), gt)
    _, ms = harness.host_ms(lambda: [full(1e-4 * (it + 1)) for it in range(ITERS)], dev)
    ms /= ITERS
    print(f"full int8 scan: {ms:.1f} ms/batch ({B / (ms / 1e3):.0f} qps), "
          f"recall@10={r_full:.4f}", flush=True)
    return harness.emit({"script": "bench_band", "card": card, "N": N, "nlist": NLIST, "B": B,
                         "build_s": build_s, "n_tiles": n_tiles, "rows": rows,
                         "full_scan": {"recall": r_full, "ms": ms, "qps": B / (ms / 1e3)},
                         "launches": harness.launches()})


if __name__ == "__main__":
    main()
