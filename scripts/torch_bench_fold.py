"""The in-place merge at config #4's scale (counterpart of scripts/bench_fold.py):
``merge_pending`` on a compact residual-int8 arena built with
``merge_headroom`` shifts the rows right inside the arena's own buffer: no
second arena, no host copy of the payload.

Usage: python scripts/torch_bench_fold.py
Env:   N=12500000, ADD=131072, HEADROOM=0.06, NLIST=4096

It builds N rows (whole chunks of 500,000 of bench.py's process) by
``build_device_streaming(merge_headroom=HEADROOM)``, adds ADD rows (chunk
seed 777; pending, scanned exactly), times the fold (``merge_pending``,
fenced), and fails unless the arena is the same buffer of the same
capacity. Then the self-hit@1 of the first 256 added rows (tile_q 64) at
the reference's p_tiles = min(640, n_tiles) and at full coverage, both
ways: the row's own id (N + i) and the reference's measure, any added id
(>= N). The own id at full coverage must reach SELF_HIT_MERGED, the bar of
the reference's test (tests/unit/test_band_ivf.py:538, at every tile);
at p 640 a group of 64 scattered queries lights more tiles than the table
holds, so the reference op point's figure is reported, not held. Ends with
one JSON line.
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

D = 768
CHUNK = 500_000
SELF_HIT_ROWS = 256
#: the reference test's bar for merged rows at full coverage (chip_smoke.py's
#: SELF_HIT_MERGED)
SELF_HIT_MERGED = 0.90
#: the added rows' chunk seed (the reference's PRNGKey(777))
ADD_SEED = 777


def self_hits(found: np.ndarray, n0: int) -> tuple[float, float]:
    """(own, any_added) self-hit@1 of added rows i = 0, 1, ... with ids
    n0 + i: the share that found its own id, and the share that found any
    added id (bench_fold.py:80's measure)."""
    top = found[:, 0]
    return (float((top == n0 + np.arange(top.shape[0])).mean()), float((top >= n0).mean()))


def main(argv=None, device="cuda") -> dict:
    dev = as_device(device)
    n_env = int(os.environ.get("N", 12_500_000))
    add = int(os.environ.get("ADD", 131_072))
    headroom = float(os.environ.get("HEADROOM", 0.06))
    nlist = int(os.environ.get("NLIST", 4096))
    n_chunks = n_env // CHUNK
    n = n_chunks * CHUNK
    card = harness.card_line(dev)
    print(f"bench_fold: N={n} ADD={add} HEADROOM={headroom} nlist={nlist}; {card}", flush=True)
    chunk_fn = harness.latent_corpus(dev, D, [CHUNK] * n_chunks)
    harness.reset_launches()

    t0 = time.perf_counter()
    idx = BandIVFIndex.build_device_streaming(chunk_fn, n_chunks, nlist=nlist, kmeans_iters=10,
                                              residual=True, merge_headroom=headroom,
                                              device=dev)
    harness.sync(dev)
    build_s = time.perf_counter() - t0
    cap = int(idx._payload.shape[0])
    ptr = idx._payload.data_ptr()
    print(f"build {build_s:.1f}s n={idx.ntotal} cap_rows={cap} (headroom {headroom:.2f} -> "
          f"{cap - idx.ntotal} spare rows, {(cap - idx.ntotal) * D / 2**20:.0f} MiB)",
          flush=True)

    new_rows = harness.latent_corpus(dev, D, {ADD_SEED: add})(ADD_SEED)
    _, add_ms = harness.host_ms(lambda: idx.add(new_rows), dev)  # pending: exact scan
    _, fold_ms = harness.host_ms(idx.merge_pending, dev)
    inplace = int(idx._payload.shape[0]) == cap and idx._payload.data_ptr() == ptr
    print(f"fold {add} rows: {fold_ms / 1e3:.3f}s fenced ("
          f"{'IN-PLACE zero-fetch' if inplace else 'HOST fallback'}; capacity "
          f"{'unchanged' if inplace else 'resized'}; pending {idx._pending.size})", flush=True)
    if not inplace:
        raise AssertionError("expected the in-place path at this headroom")

    # post-fold correctness: the added rows retrieve themselves, at the
    # reference's op point and at full coverage, where the bar holds
    q = new_rows[:SELF_HIT_ROWS].cpu().numpy()
    n_tiles = cap // idx.tile_n
    hits = {}
    for name, p in (("op", min(640, n_tiles)), ("full", n_tiles)):
        _, found = idx.search(q, 1, p_tiles=p, tile_q=64)
        own, any_added = self_hits(found, n)
        hits[name] = {"p_tiles": p, "own": own, "any_added": any_added}
        print(f"post-fold self-hit@1 (added rows) at p {p} = {own:.3f} own id, {any_added:.3f} "
              f"any added id (the reference's measure); ntotal={idx.ntotal}", flush=True)
    if hits["full"]["own"] < SELF_HIT_MERGED:
        raise AssertionError(f"self-hit@1 at full coverage {hits['full']['own']:.3f} < "
                             f"{SELF_HIT_MERGED}")
    return harness.emit({"script": "bench_fold", "card": card, "N": n, "add": add,
                         "headroom": headroom, "nlist": nlist, "build_s": build_s,
                         "cap_rows": cap, "add_s": add_ms / 1e3, "fold_s": fold_ms / 1e3,
                         "inplace": inplace, "self_hit": hits, "ntotal": idx.ntotal,
                         "launches": harness.launches()})


if __name__ == "__main__":
    main()
