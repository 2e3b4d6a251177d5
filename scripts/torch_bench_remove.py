"""Deletion throughput at serving scale (counterpart of scripts/bench_remove.py):
the residual-int8 slack arena removes rows in place (no rebuild, no host
round trip of the payload) and ``add`` refills the freed slots.

Usage: python scripts/torch_bench_remove.py
Env:   N_ROWS=4000000 (12500000: config #4's share), CHUNK=500000, NLIST=2048,
       REMOVE_B=8192, SLACK=0.05, P_TILES=640, ROUNDS=4

Each round removes REMOVE_B live ids drawn by ``np.random.default_rng(3)``;
its host+dispatch time is the host clock over ``remove``, its fenced time
that plus the card's synchronisation (the host's id scan and per-list
planning are part of the cost, and reported as the host share). After the
removes the 512 queries (noisy copies of chunk 0's rows) must return no
removed id, and no filled slot may hold -1 (a hole): two checks, where the
reference counts a -1 as a removed id. Their top-10 overlap with the
pre-remove results is reported. Then REMOVE_B new rows (chunk seed 9999)
refill the freed slots, fenced, and ntotal must read
N - removed + REMOVE_B. Ends with one JSON line.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from cloudvectordb_tpu_torch.eval import harness  # noqa: E402
from cloudvectordb_tpu_torch.index.ivf_band import BandIVFIndex  # noqa: E402
from cloudvectordb_tpu_torch.utils.device import as_device  # noqa: E402

D, K = 768, 10
NQ = 512
#: the refill's chunk seed (the reference's PRNGKey(9999))
REFILL_SEED = 9999


def post_remove_faults(v: np.ndarray, ids: np.ndarray, removed: np.ndarray) -> tuple[int, int]:
    """(slots holding a removed id, filled slots holding -1) of a search's
    scores ``v`` and ids after ``removed`` were deleted. A slot is filled
    when its score is finite; an unfilled -1 is neither."""
    return (int(np.isin(ids, removed).sum()), int(((ids == -1) & np.isfinite(v)).sum()))


def main(argv=None, device="cuda") -> dict:
    dev = as_device(device)
    n_env = int(os.environ.get("N_ROWS", 4_000_000))
    chunk = int(os.environ.get("CHUNK", 500_000))
    nlist = int(os.environ.get("NLIST", 2048))
    remove_b = int(os.environ.get("REMOVE_B", 8192))
    slack = float(os.environ.get("SLACK", 0.05))
    rounds = int(os.environ.get("ROUNDS", 4))
    n_chunks = n_env // chunk
    n = n_chunks * chunk
    card = harness.card_line(dev)
    chunk_fn = harness.latent_corpus(dev, D, [chunk] * n_chunks)
    harness.reset_launches()

    t0 = time.perf_counter()
    idx = BandIVFIndex.build_device_streaming(chunk_fn, n_chunks, nlist=nlist, kmeans_iters=10,
                                              residual=True, slack=slack, device=dev)
    harness.sync(dev)
    build_s = time.perf_counter() - t0
    print(f"[build] {n}x{D} slack={slack} in {build_s:.0f} s; {card}", flush=True)

    q = harness.noisy_queries(chunk_fn(0), NQ).cpu().numpy()
    n_tiles = int(idx._payload.shape[0]) // idx.tile_n
    p = min(int(os.environ.get("P_TILES", 640)), n_tiles)
    _, g0 = idx.search(q, K, p_tiles=p)

    rng = np.random.default_rng(3)
    removed, t_host, t_all, round_rows = [], 0.0, 0.0, []
    for r in range(rounds):
        live = np.asarray(idx._ids[: idx._n])
        live = live[live >= 0]
        victims = rng.choice(live, remove_b, replace=False)
        harness.sync(dev)
        t0 = time.perf_counter()
        nrem = idx.remove(victims)
        t1 = time.perf_counter()
        harness.sync(dev)  # fence the device scatter
        t2 = time.perf_counter()
        if nrem != remove_b:
            raise AssertionError(f"removed {nrem} of {remove_b}")
        removed.append(victims)
        t_host += t1 - t0
        t_all += t2 - t0
        round_rows.append({"rows": nrem, "host_s": t1 - t0, "fenced_s": t2 - t0})
        print(f"[remove {r}] {nrem} rows: host+dispatch {t1 - t0:.3f} s, fenced {t2 - t0:.3f} s",
              flush=True)
    removed = np.concatenate(removed)
    rate = removed.size / t_all
    print(f"[remove] {removed.size} rows in {t_all:.2f} s fenced ({rate:,.0f} rows/s; host "
          f"share {t_host / t_all:.0%})", flush=True)

    # deleted ids never surface; survivors' results unchanged except where
    # a true neighbour was deleted
    v1, g1 = idx.search(q, K, p_tiles=p)
    n_removed, n_holes = post_remove_faults(v1, g1, removed)
    overlap = float(np.isin(g0, g1).mean())
    print(f"[post] ntotal {idx.ntotal}, top-{K} overlap with pre-remove: {overlap:.3f}; removed "
          f"ids returned {n_removed}, filled slots holding -1 {n_holes}", flush=True)
    if n_removed or n_holes:
        raise AssertionError(f"{n_removed} removed ids returned, {n_holes} filled -1 slots")

    # refill: adds land in the freed slack slots in place
    rows = harness.latent_corpus(dev, D, {REFILL_SEED: remove_b})(REFILL_SEED)
    _, refill_ms = harness.host_ms(lambda: idx.add(rows), dev)
    print(f"[refill] add {remove_b} rows in {refill_ms / 1e3:.3f} s (pending "
          f"{idx._pending.size})", flush=True)
    if idx.ntotal != n - removed.size + remove_b:
        raise AssertionError(f"ntotal {idx.ntotal} != {n - removed.size + remove_b}")
    return harness.emit({"script": "bench_remove", "card": card, "N": n, "nlist": nlist,
                         "slack": slack, "p_tiles": p, "build_s": build_s, "rounds": round_rows,
                         "removed": int(removed.size), "rows_per_s": rate,
                         "host_share": t_host / t_all, "overlap": overlap,
                         "refill_s": refill_ms / 1e3, "pending": idx._pending.size,
                         "ntotal": idx.ntotal, "launches": harness.launches()})


if __name__ == "__main__":
    main()
