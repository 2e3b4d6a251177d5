"""Arithmetic the readers of the program's spans share. The program
(``cloudvectordb_tpu_torch/utils/metrics.py``) records a span while a
profiler runs, so its records are those of the traced calls: each reader
here groups them by the ``cvdb.search`` call they lie in, and returns None
where there is nothing to read (no trace or no device op in it, a program
that records no spans or dropped some, or a number of calls that differs
from the trace's).

A span makes no device call, so its device time comes from the trace: the
device ops it issued are those whose launch (a ``cudaLaunchKernel``,
``cudaMemcpyAsync`` or the like on the host) lies inside the span's host
interval. One stream runs its ops in launch order, so the i-th launch of the
window put the i-th device op on the card; where launches and device ops
differ in number or in kind (kernel, copy, fill), nothing is read."""

from __future__ import annotations

import bisect
import statistics

from cvdb_bench import trace

#: host spans of ``search()``'s copies in and out of the card
COPIES = ("cvdb.search.in", "cvdb.search.out")
#: host calls that put one op on the card: a kernel launch, a copy, a fill
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
#: launch calls that put none
NOT_LAUNCHES = ("cudaLaunchHostFunc", "cuLaunchHostFunc")


def program_records():
    """The program's finished span records, or None where it keeps none or
    dropped some past its bound."""
    try:
        from cloudvectordb_tpu_torch.utils import metrics
    except ImportError:
        return None
    read = getattr(metrics, "span_records", None)
    if read is None:
        return None
    got = read()
    return None if got["dropped"] else got["records"]


def calls(ctx):
    """The records of each traced call (a list a call, in call order), or
    None."""
    tr = ctx.trace
    if tr is None or not tr.kernels:
        return None
    recs = program_records()
    if not recs:
        return None
    by_call = {r["call"]: [] for r in recs if r["root"]}
    if len(by_call) != tr.n_calls:
        return None
    for r in recs:
        if r["call"] in by_call:
            by_call[r["call"]].append(r)
    return list(by_call.values())


def _kind(name: str, host: bool) -> str:
    if name.startswith("Memcpy") or host and "Memcpy" in name:
        return "copy"
    if name.startswith("Memset") or host and "Memset" in name:
        return "fill"
    return "kernel"


def launched(tr):
    """(the host start of each launch, the (start, end) of the device op it
    put on the card), both in launch order; None where the trace's launches
    and device ops differ in number or kind."""
    launches = sorted((a, _kind(name, True)) for name, a, _ in tr.host_ops
                      if name.startswith(LAUNCHES) and not name.startswith(NOT_LAUNCHES))
    ops = sorted(tr.kernels, key=lambda op: op[1])
    if len(launches) != len(ops):
        return None
    if any(kind != _kind(name, False) for (_, kind), (name, _, _) in zip(launches, ops)):
        return None
    return [a for a, _ in launches], [(a, b) for _, a, b in ops]


def device_ms(ctx, name: str):
    """The median over the traced calls of the device ms of the ops that
    the spans ``name`` of a call issued (the union of their intervals, so
    idle time between them is not counted); None if a call has no such
    span."""
    if calls(ctx) is None:
        return None
    tr = ctx.trace
    got = launched(tr)
    if got is None:
        return None
    starts, ops = got
    inst = [(a, b) for n, a, b in tr.host_ops if n == name]
    per_call = []
    for ca, cb in tr.calls:
        mine = [(a, b) for a, b in inst if a >= ca and b <= cb]
        if not mine:
            return None
        issued = [ops[i] for a, b in mine
                  for i in range(bisect.bisect_left(starts, a), bisect.bisect_right(starts, b))]
        per_call.append(sum(b - a for a, b in trace.union(issued)))
    return 1e3 * statistics.median(per_call)


def count(ctx, name: str, key: str):
    """The sum of count ``key`` of the spans ``name`` a traced call."""
    groups = calls(ctx)
    if groups is None:
        return None
    vals = [r["counts"][key] for g in groups for r in g if r["name"] == name]
    if not vals:
        return None
    return sum(vals) / len(groups)


def scan_issued_tbs(ctx):
    """The ``cvdb.scan`` spans' tile bytes a call over the scan kernels'
    device time a call in the trace (``ctx.kernels``' names), in TB/s."""
    tr = ctx.trace
    names = tuple(n for group in (ctx.kernels or {}).values() for n in group)
    b = count(ctx, "cvdb.scan", "tile_read_bytes")
    if b is None or not names or not tr.has(names):
        return None
    return b / (tr.kernel_s(names) / tr.n_calls) / 1e12


def copy_idle_ms(ctx):
    """The median over the traced calls of the ms in which the card is idle
    while the host is inside ``search()``'s copy spans: the profiler's host
    spans against the union of the device ops, on the trace's clock."""
    if calls(ctx) is None:
        return None
    tr = ctx.trace
    copies = [(a, b) for name, a, b in tr.host_ops if name in COPIES]
    if not copies or not tr.calls:
        return None
    merged = trace.union((a, b) for _, a, b in tr.kernels)
    per_call = []
    for ca, cb in tr.calls:
        inside = [(a, b) for a, b in copies if a >= ca and b <= cb]
        per_call.append(sum((b - a) - trace.covered((a, b), merged) for a, b in inside))
    return 1e3 * statistics.median(per_call)
