"""Device-resident query throughput (counterpart of cloudvectordb_tpu/eval/qps.py).

Timed with CUDA events around each repetition of a device-level search
function. Each repetition gets distinct inputs (the queries plus a small
per-repetition offset, made before the start event), as the reference's
bench does, and the reported rate is the median repetition's. There is no
relay round trip to subtract, and no CPU fallback: a measurement without a
card raises.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


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
