"""Query throughput (counterpart of cloudvectordb_tpu/eval/qps.py).

``qps_device`` times a device-level search function with CUDA events around
each repetition; the reported rate is the median repetition's, and a
measurement without a card raises. ``qps_bench`` is the reference's
host-clock protocol for a search that returns numpy (``index.search``):
that return is the fence (the copy to the host waits for the card), so it
runs on any device, the CPU included. Each
repetition of either gets distinct inputs (the queries plus a small
per-repetition offset), as the reference's bench does. There is no relay
round trip to subtract.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import numpy as np
import torch


def qps_bench(search_fn: Callable, queries, *, batch: int | None = None,
              warmup: int = 1, iters: int = 3) -> dict:
    """Steady-state queries/second of ``search_fn(queries_batch)``, which
    returns host arrays, (scores, ids) or scores alone: host clock over
    ``iters`` passes over the queries in batches of ``batch``, each pass
    with distinct inputs. Returns ``{"qps", "latency_ms", "batch"}``."""
    queries = np.asarray(queries, np.float32)
    nq = queries.shape[0]
    batch = batch or nq

    def run_once(noise: float) -> None:
        for s in range(0, nq, batch):
            out = search_fn(queries[s : s + batch] + np.float32(noise))
            np.asarray(out[0] if isinstance(out, (tuple, list)) else out)

    for _ in range(warmup):
        run_once(0.0)
    t0 = time.perf_counter()
    for i in range(iters):
        run_once(1e-4 * (i + 1))
    dt = time.perf_counter() - t0
    return {"qps": nq * iters / dt, "latency_ms": 1000.0 * dt / (iters * -(-nq // batch)),
            "batch": batch}


def qps_device(search_fn: Callable, queries: torch.Tensor, *, reps: int = 5,
               warmup: int = 2) -> dict:
    """Measure ``search_fn(queries_batch) -> (scores, ids)`` on CUDA tensors.

    Returns ``{"qps", "ms_median", "ms_min", "ms_max", "ms", "reps",
    "batch", "device"}``; ``qps`` is batch / median repetition time.
    """
    if not queries.is_cuda:
        raise RuntimeError("qps_device measures a CUDA device; got "
                           f"queries on {queries.device}")
    if reps < 1:
        raise ValueError("reps must be >= 1")
    dev = queries.device
    for w in range(warmup):
        search_fn(queries + 0.5e-4 * (w + 1))
    torch.cuda.synchronize(dev)
    times = []
    for i in range(reps):
        qi = queries + 1e-4 * (i + 1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        search_fn(qi)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    med = statistics.median(times)
    return {
        "qps": queries.shape[0] / (med / 1000.0),
        "ms_median": med,
        "ms_min": min(times),
        "ms_max": max(times),
        "ms": times,
        "reps": reps,
        "batch": int(queries.shape[0]),
        "device": torch.cuda.get_device_name(dev),
    }
