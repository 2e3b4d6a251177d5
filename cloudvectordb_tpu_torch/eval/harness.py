"""What the measuring scripts (``scripts/torch_*.py``) share: the synthetic
corpora of the reference's benches drawn on the device, their noisy
queries, the exact (optionally filtered) top-k over a chunked corpus,
fenced timing, the kernels' launch counts and the closing JSON line. The
JAX package keeps these inside each of its scripts.

Timing on the card is fenced: ``torch.cuda.synchronize()`` around a
host-clock span, or CUDA events around a device span. On the CPU (the
tests) the host clock is the fence. There is no relay round trip to
subtract.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from cloudvectordb_tpu_torch.index.ivf_band import _pq_tiles_plan_search, _scan_topk
from cloudvectordb_tpu_torch.ops import attn, band, flat_topk, pq
from cloudvectordb_tpu_torch.ops.topk import NEG_INF, _score_block, merge_topk

#: the generating process of the reference's benches (bench.py): a 32-d
#: latent of 256 unit centres, noise 0.3/sqrt(32), a random linear map to D,
#: rows L2-normalised
LATENT, NCENTERS = 32, 256


def chunk_sizes(n: int, chunk: int) -> list[int]:
    """The reference's chunking: full chunks, then the remainder."""
    return [chunk] * (n // chunk) + ([n % chunk] if n % chunk else [])


def latent_corpus(dev: torch.device, d: int, sizes, seed: int = 1000,
                  rotation: torch.Tensor | None = None):
    """chunk_fn(i) -> (sizes[i], d) f32 rows on ``dev``, deterministic: the
    map and centres from ``seed``, chunk i's draws from seed i, all from
    ``torch.Generator``s (``sizes`` a list, or a dict from chunk seeds). ``rotation`` (d, d), when given, maps each row x
    to x @ rotation.T (rows made straight in a rotated space)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = torch.randn((LATENT, d), generator=g, device=dev) / LATENT ** 0.5
    centers = torch.randn((NCENTERS, LATENT), generator=g, device=dev)
    centers = centers / centers.norm(dim=1, keepdim=True)
    if rotation is not None:
        w = w @ rotation.to(dev).T

    def chunk_fn(i: int) -> torch.Tensor:
        gi = torch.Generator(device=dev)
        gi.manual_seed(i)
        m = sizes[i]
        a = torch.randint(0, NCENTERS, (m,), generator=gi, device=dev)
        z = centers[a] + (0.3 / LATENT ** 0.5) * torch.randn((m, LATENT), generator=gi,
                                                             device=dev)
        x = z @ w
        return x / x.norm(dim=1, keepdim=True)

    return chunk_fn


def noisy_queries(base: torch.Tensor, batch: int, seed: int = 7777,
                  noise: float = 0.15) -> torch.Tensor:
    """``batch`` noisy copies of rows of ``base`` (noise norm ``noise``),
    L2-normalised, drawn on ``base``'s device."""
    g = torch.Generator(device=base.device)
    g.manual_seed(seed)
    d = base.shape[1]
    sel = torch.randint(0, base.shape[0], (batch,), generator=g, device=base.device)
    q = base[sel] + (noise / d ** 0.5) * torch.randn((batch, d), generator=g,
                                                     device=base.device)
    return q / q.norm(dim=1, keepdim=True)


def direct_corpus(dev: torch.device, n: int, d: int, nq: int, seed: int = 0):
    """(rows, queries) of scripts/bench_band.py's and bench_ivf.py's process
    on the device: unit rows about 256 unit centres in D (noise 0.3/sqrt(d)),
    and noisy copies of random rows (noise 0.1/sqrt(d)), drawn from a seeded
    torch.Generator."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    centers = torch.randn((NCENTERS, d), generator=g, device=dev)
    centers = centers / centers.norm(dim=1, keepdim=True)
    a = torch.randint(0, NCENTERS, (n,), generator=g, device=dev)
    x = centers[a] + (0.3 / d ** 0.5) * torch.randn((n, d), generator=g, device=dev)
    x = x / x.norm(dim=1, keepdim=True)
    sel = torch.randint(0, n, (nq,), generator=g, device=dev)
    q = x[sel] + (0.1 / d ** 0.5) * torch.randn((nq, d), generator=g, device=dev)
    return x, q / q.norm(dim=1, keepdim=True)


def exact_topk_chunks(chunk_fn, n_chunks: int, q: torch.Tensor, k: int,
                      metric: str = "ip", allow: torch.Tensor | None = None,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact f32 top-k (scores, global row ids) of ``q`` over the chunks
    (TF32 off), ties to the lower id. ``allow`` (N,) bool by global row
    restricts it to the allowed rows: the others score -inf, and a slot no
    allowed row fills holds (-inf, -1)."""
    best, base = None, 0
    for ci in range(n_chunks):
        x = chunk_fn(ci)
        ok = None if allow is None else allow[base:base + x.shape[0]]
        v, pos = _scan_topk(lambda lo, hi: _score_block(q, x[lo:hi], metric), x.shape[0],
                            k, q.shape[0], ok)
        best = (v, pos + base) if best is None else merge_topk(*best, v, pos + base, k)
        base += x.shape[0]
    if allow is not None:
        best = best[0], torch.where(best[0] > NEG_INF, best[1], -1)
    return best


def pq_tier1(idx, q: torch.Tensor, *, k: int, k_cand: int, n_pools: int, l_buckets: int,
             tile_q: int, p_tiles: int, top2: bool = False):
    """A ``BandIVFPQIndex``'s K5 search with no rescore: (scores, ids) of the
    top-k of k_cand candidates by their tier-1 scores, for rotated queries
    ``q`` (a multiple of tile_q)."""
    st = idx._device_state()
    return _pq_tiles_plan_search(
        q, st["centroids"], st["codes"], st["codebooks"], st["refine"], st["ids"],
        st["tile_window"], st["centroid_tiles"], idx._n, st["local"], k=k, k_cand=k_cand,
        p_tiles=p_tiles, tile_n=idx.tile_n, tile_q=tile_q, refine_scale=0.0, n_pools=n_pools,
        l_buckets=l_buckets, top2=top2, segments=idx._seg_rows())


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev: torch.device) -> tuple[object, float]:
    """(fn(), milliseconds of the host clock from a fence before the call to
    a fence after it)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def device_ms(fn, dev: torch.device, reps: int) -> list[float]:
    """Milliseconds of each of ``reps`` calls of ``fn(i)``: CUDA events
    around each call on the card, the fenced host clock on the CPU."""
    out = []
    for i in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(i)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            out.append(host_ms(lambda: fn(i), dev)[1])
    return out


def p50_p99(values) -> tuple[float, float]:
    """The reference's reduction of a latency sample: sorted, the entries
    at n // 2 and int(0.99 n)."""
    s = np.sort(np.asarray(values, np.float64))
    return float(s[len(s) // 2]), float(s[int(len(s) * 0.99)])


#: the kernel wrappers' launch counters, by the kernel table's names
_COUNTERS = {"K1": (band.tiles_topk_resid, "launches"), "K1b": (band.resid_row_bias, "launches"),
             "K2": (flat_topk.flat_topk, "launches"), "K3": (band.tiles_topk, "launches"),
             "K7": (band.band_topk, "launches"), "K5": (pq.pq_tiles_topk, "launches"),
             "K5 seg": (pq.pq_tiles_topk, "seg_launches"),
             "K5b": (pq.pq_row_bias, "launches"), "K6": (pq.pq_topk, "launches"),
             "K4": (attn.mha_small_head, "launches"),
             "K4 bwd": (attn.mha_small_head, "bwd_launches")}


def reset_launches() -> None:
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)


def launches() -> dict[str, int]:
    """Each kernel's launches since the last reset (0 on the CPU, where the
    wrappers run their plain versions)."""
    return {name: int(getattr(fn, attr)) for name, (fn, attr) in _COUNTERS.items()}


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; 'cpu' on
    the CPU."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0]


def emit(numbers: dict) -> dict:
    """Print the closing JSON line of a script's numbers; return them."""
    print(json.dumps(numbers, default=float), flush=True)
    return numbers
