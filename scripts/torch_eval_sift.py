"""BASELINE configs #1/#2 on SIFT1M-format data (counterpart of
scripts/eval_sift.py): the exact row, then an IVF-Flat nprobe sweep.

With SIFT1M files (``--base sift_base.fvecs --query sift_query.fvecs
[--gt sift_groundtruth.ivecs]``, read with ``read_fvecs``/``read_ivecs``)
this evaluates the dataset; without them it draws synthetic clustered
128-d vectors of the same shape (SURVEY.md §4.2). Prints the exact row
(``FlatIndex.search(exact=True)``, the tiled f32 scan, as the reference's),
the fused row (the same index searched through K2, the flat kernel, on the
card), one JSON line per nprobe and the operating point, then one JSON line
of every number.

    python scripts/torch_eval_sift.py [--base B --query Q [--gt G]] [--n 200000]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cloudvectordb_tpu_torch.data.synthetic import (  # noqa: E402
    clustered_vectors, queries_from, read_fvecs, read_ivecs)
from cloudvectordb_tpu_torch.eval import harness  # noqa: E402
from cloudvectordb_tpu_torch.eval.recall import brute_force_topk, recall_at_k  # noqa: E402
from cloudvectordb_tpu_torch.eval.sweep import nprobe_sweep, operating_point  # noqa: E402
from cloudvectordb_tpu_torch.index.flat import FlatIndex  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_flat import IVFFlatIndex  # noqa: E402
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

NPROBES = (1, 2, 4, 8, 16, 32, 64, 128)


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default=None)
    ap.add_argument("--query", default=None)
    ap.add_argument("--gt", default=None)
    ap.add_argument("--n", type=int, default=200_000, help="synthetic DB size")
    ap.add_argument("--nq", type=int, default=1000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--metric", default="l2", choices=["l2", "ip"])
    return ap.parse_args(argv)


def load(args):
    """(base, queries, ground truth or None, source label)."""
    if args.base:
        base = read_fvecs(args.base)
        queries = read_fvecs(args.query, max_rows=args.nq)
        gt = read_ivecs(args.gt, max_rows=args.nq) if args.gt else None
        print(f"SIFT: base {base.shape}, queries {queries.shape}")
        return base, queries, gt, "sift"
    base = clustered_vectors(args.n, 128, n_clusters=256, seed=0)
    queries = queries_from(base, args.nq, seed=1)
    print(f"synthetic SIFT-shape: base {base.shape}, queries {queries.shape}")
    return base, queries, None, "synthetic"


def exact_row(base, queries, gt, k: int, metric: str, device) -> tuple:
    """The reference's exact row: (recall@k of ``FlatIndex.search(exact=True)``,
    the index)."""
    flat = FlatIndex.build(base, metric=metric, device=device)
    _, i_flat = flat.search(queries, k, exact=True)
    return recall_at_k(i_flat, gt), flat


def main(argv=None, device="cuda") -> dict:
    args = parse(sys.argv[1:] if argv is None else argv)
    dev = as_device(device)
    card = harness.card_line(dev)
    base, queries, gt, source = load(args)
    if gt is None:
        _, gt = brute_force_topk(base, queries, args.k, metric=args.metric)
    harness.reset_launches()

    # config #1: exact brute-force sanity
    exact, flat = exact_row(base, queries, gt, args.k, args.metric, dev)
    print(f"exact recall@{args.k}: {exact:.4f} (must be 1.0)")
    # the same index through the fused flat scan (K2 on the card)
    _, i_fused = flat.search(queries, args.k)
    fused = recall_at_k(i_fused, gt)
    print(f"fused recall@{args.k}: {fused:.4f}")
    del flat

    # config #2 shape: IVF-Flat nprobe sweep
    ivf = IVFFlatIndex.build(base, nlist=args.nlist, metric=args.metric, kmeans_iters=10,
                             device=dev)
    rows = nprobe_sweep(ivf, base, queries, k=args.k, nprobes=NPROBES, gt_ids=gt)
    for r in rows:
        print(json.dumps(r))
    op = operating_point(rows, 0.95)
    print("operating point (recall≥0.95):", json.dumps(op))
    return harness.emit({"script": "eval_sift", "card": card, "source": source,
                         "base": list(base.shape), "nq": int(queries.shape[0]), "k": args.k,
                         "metric": args.metric, "nlist": args.nlist, "exact_recall": exact,
                         "fused_recall": fused, "sweep": rows, "operating_point": op,
                         "launches": harness.launches()})


if __name__ == "__main__":
    main()
