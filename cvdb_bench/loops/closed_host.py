"""One client in a closed loop of host calls: ``search()`` with numpy in
and numpy out (its return is the fence), on a host pool of query batches
cycled. A call's latency is the host clock around it; every call of the
window counts."""

from __future__ import annotations

import time

from torch.profiler import record_function

from cvdb_bench import trace

POOL = "host"  # the pool this loop takes: numpy arrays in host memory


def warm(served, pool, mix, dev) -> None:
    for q in pool[: int(mix["warm_batches"])]:
        served.search_host(q)


def window(served, pool, mix, dev, seconds: float, judged) -> dict:
    nb, b = len(pool), int(mix["batch"])
    answers, lat = {}, []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        j = i % nb
        ta = time.perf_counter()
        v, ids = served.search_host(pool[j])
        lat.append((time.perf_counter() - ta) * 1e3)
        if j in judged:
            answers[j] = (v, ids)
        i += 1
    elapsed = time.perf_counter() - t0
    return {"calls": i, "queries": i * b, "seconds": elapsed, "answers": answers,
            "latencies_ms": lat}


def traced(served, pool, mix, dev) -> trace.Trace:
    n = int(mix["trace_batches"])

    def body():
        for i in range(n):
            with record_function(trace.CALL):
                served.search_host(pool[i % len(pool)])
        return n

    return trace.profile(body, dev)
