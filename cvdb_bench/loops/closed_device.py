"""One client in a closed loop of device batches: ``search_device`` on a
pool of query batches staged on the card and cycled, up to ``in_flight``
batches dispatched ahead (a CUDA event a batch; the host waits for batch
i - in_flight before it dispatches batch i + 1), one fence at the end of
the window. Every batch dispatched in the window is counted, and the
window ends at that fence."""

from __future__ import annotations

import time
from collections import deque

import torch
from torch.profiler import record_function

from cvdb_bench import trace

POOL = "device"  # the pool this loop takes: tensors on the card


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def warm(served, pool, mix, dev) -> None:
    for q in pool[: int(mix["warm_batches"])]:
        served.search_device(q)
    _sync(dev)


def window(served, pool, mix, dev, seconds: float, judged) -> dict:
    depth = int(mix["in_flight"])
    nb, b = len(pool), int(mix["batch"])
    answers, fences = {}, deque()
    _sync(dev)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        j = i % nb
        v, ids = served.search_device(pool[j])
        if j in judged:
            answers[j] = (v.clone(), ids.clone())
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            fences.append(ev)
            if len(fences) > depth:
                fences.popleft().synchronize()
        i += 1
    _sync(dev)
    elapsed = time.perf_counter() - t0
    return {"calls": i, "queries": i * b, "seconds": elapsed, "answers": answers,
            "latencies_ms": []}


def traced(served, pool, mix, dev) -> trace.Trace:
    n = int(mix["trace_batches"])

    def body():
        for i in range(n):
            with record_function(trace.CALL):
                served.search_device(pool[i % len(pool)])
        return n

    return trace.profile(body, dev)
