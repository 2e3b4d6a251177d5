"""IVF-PQ probe-scan benchmark (counterpart of scripts/bench_ivf.py): recall@10
and fenced QPS at 1M x 768, m 64, nlist 1024, BASELINE config #3's shape
on one card, over an arena the script builds by hand.

Usage: python scripts/torch_bench_ivf.py

The corpus is the reference's (``harness.direct_corpus``, B 256 queries),
its ground truth the exact f32 top-10. The build is the reference's stages,
timed as one fenced span: k-means on the first 262,144 rows (10
iterations), the assignment of every row, PQ codebooks on the sample's
residuals (m 64, 8 bits, 6 iterations) and the encode of every residual in
chunks of 250,000. The arena is sorted on the host, timed apart
(``host_arena``: a stable argsort by list, counts, offsets, lengths, the
longest list). ``scan_state`` stages it as ``index/ivf_pq.py``'s
``_ivfpq_scan_search`` reads an index's state; arena rows map to ids
through the script's own ``ids``. At nprobe 16: recall@10, and ms and QPS
over 3 fenced calls on queries moved by a small constant. No hand-written
kernel runs here: the probe scan is PyTorch's gathers, products and sorts,
as the reference leaves its scan to XLA. Ends with one JSON line.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cloudvectordb_tpu_torch.eval import harness  # noqa: E402
from cloudvectordb_tpu_torch.eval.recall import recall_at_k  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_flat import rows_to_ids  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_pq import _ivfpq_scan_search  # noqa: E402
from cloudvectordb_tpu_torch.index.kmeans import train_kmeans  # noqa: E402
from cloudvectordb_tpu_torch.index.pq import pq_encode, train_pq  # noqa: E402
from cloudvectordb_tpu_torch.ops.assign import assign_clusters  # noqa: E402
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

N, D, M, NLIST, K, B = 1_000_000, 768, 64, 1024, 10, 256
SAMPLE = 262_144
ENC_CHUNK = 250_000
NPROBES = (16,)
ITERS = 3


def host_arena(a_np: np.ndarray, codes_np: np.ndarray, nlist: int):
    """(arena codes, ids, offsets, lens, cap) of the rows sorted by list
    (bench_ivf.py:72-78): arena row r holds source row ids[r]."""
    order = np.argsort(a_np, kind="stable")
    counts = np.bincount(a_np, minlength=nlist)
    offsets = np.concatenate([[0], np.cumsum(counts)])[:-1].astype(np.int32)
    lens = counts.astype(np.int32)
    return codes_np[order], order.astype(np.int32), offsets, lens, int(lens.max())


def scan_state(centroids, arena, offsets, lens, codebooks, dev) -> dict:
    """The state ``_ivfpq_scan_search`` reads, with the keys of
    ``IVFPQIndex._device_state``: the coarse quantizer, each list's start
    and length, the codes, the codebooks and their squared norms."""
    cb = torch.as_tensor(codebooks, dtype=torch.float32, device=dev)
    return dict(centroids=torch.as_tensor(centroids, dtype=torch.float32, device=dev),
                starts=torch.as_tensor(offsets, device=dev).long(),
                lens=torch.as_tensor(lens, device=dev).long(),
                codes=torch.as_tensor(arena, device=dev), codebooks=cb,
                c_sq_codes=(cb * cb).sum(dim=2))


def build(x: torch.Tensor):
    """The reference's device build: (centroids, assignments, codebooks,
    codes)."""
    sample = x[:SAMPLE]
    centroids, _ = train_kmeans(sample, NLIST, iters=10, tile=8192)
    assign, _ = assign_clusters(x, centroids)
    codebooks = train_pq(sample - centroids[assign[:SAMPLE]], M, 8, iters=6)
    codes = torch.cat([pq_encode(x[s:s + ENC_CHUNK] - centroids[assign[s:s + ENC_CHUNK]],
                                 codebooks) for s in range(0, x.shape[0], ENC_CHUNK)])
    return centroids, assign, codebooks, codes


def main(argv=None, device="cuda") -> dict:
    dev = as_device(device)
    card = harness.card_line(dev)
    print(f"bench_ivf: N={N} D={D} m={M} nlist={NLIST} B={B}; {card}", flush=True)
    x, q = harness.direct_corpus(dev, N, D, B)
    _, gt = harness.exact_topk_chunks(lambda i: x, 1, q, K)
    gt = gt.cpu().numpy()
    print("data + ground truth ready", flush=True)
    harness.reset_launches()

    (centroids, assign, codebooks, codes), build_ms = harness.host_ms(lambda: build(x), dev)
    print(f"build (kmeans+assign+pq+encode) on device: {build_ms / 1e3:.1f} s for {N} vecs",
          flush=True)

    t0 = time.perf_counter()
    arena, ids, offsets, lens, cap = host_arena(assign.cpu().numpy(), codes.cpu().numpy(), NLIST)
    sort_s = time.perf_counter() - t0
    print(f"arena sort (host): {sort_s:.1f} s, cap={cap}", flush=True)

    st = scan_state(centroids, arena, offsets, lens, codebooks, dev)
    ids_d = torch.as_tensor(ids, device=dev).long()
    rows = []
    for nprobe in NPROBES:
        def run(noise, nprobe=nprobe):
            v, r = _ivfpq_scan_search(q + noise, st, k=K, nprobe=nprobe, metric="ip",
                                      residual=True)
            return v, rows_to_ids(r, ids_d)

        _, i = run(0.0)
        r = recall_at_k(i.cpu().numpy(), gt)
        _, ms = harness.host_ms(lambda: [run(1e-4 * (it + 1)) for it in range(ITERS)], dev)
        ms /= ITERS
        rows.append({"nprobe": nprobe, "recall": r, "ms": ms, "qps": B / (ms / 1e3)})
        print(f"nprobe={nprobe}: recall@10={r:.4f}  {ms:7.1f} ms/batch  "
              f"{B / (ms / 1e3):8.0f} qps", flush=True)
    return harness.emit({"script": "bench_ivf", "card": card, "N": N, "m": M, "nlist": NLIST,
                         "B": B, "build_s": build_ms / 1e3, "arena_sort_s": sort_s, "cap": cap,
                         "rows": rows, "launches": harness.launches()})


if __name__ == "__main__":
    main()
