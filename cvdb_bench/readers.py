"""Arithmetic the metric readers share: each reader in ``e2e_metrics/`` and
``layer_metrics/`` is a file of its own that calls one of these with its
own arguments. Every function returns None where the run has nothing to
read (no trace, no device op of the kernel), never 0 for a share."""

from __future__ import annotations

import math
import statistics

from cvdb_bench import roofline, trace


def percentile(values, pct: float):
    """The nearest-rank percentile of every value (no interpolation)."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(pct / 100.0 * len(s)) - 1)]


def kernel_roofline_pct(ctx, kernel: str):
    """100 x the kernel's least time a batch (``roofline.least_s`` of its
    work part) over its device time a batch in the trace."""
    tr = ctx.trace
    names = ctx.kernels.get(kernel)
    if tr is None or not names or kernel not in ctx.work or not tr.has(names):
        return None
    measured = tr.kernel_s(names) / tr.n_calls
    return 100.0 * roofline.least_s(ctx.work[kernel]) / measured


def rest_device_ms(ctx):
    """Device ms a batch of every op that is none of the cell's scan
    kernels (K1, K5)."""
    tr = ctx.trace
    if tr is None or not tr.kernels:
        return None
    scans = tuple(n for names in ctx.kernels.values() for n in names)
    return 1e3 * tr.kernel_s(None, exclude=scans) / tr.n_calls


def idle_pct(ctx):
    tr = ctx.trace
    if tr is None or not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (tr.window_s - tr.busy_s) / tr.window_s


def batch_mfu_pct(ctx):
    """100 x the batch's operations at their types' peaks over the
    traced wall time a batch."""
    tr = ctx.trace
    if tr is None or not tr.kernels or tr.n_calls == 0:
        return None
    return 100.0 * roofline.compute_s(ctx.work) / (tr.window_s / tr.n_calls)


def host_gap_ms(ctx):
    """The median over traced calls of the ms of a call that no device op
    covers."""
    tr = ctx.trace
    if tr is None or not tr.kernels or not tr.calls:
        return None
    merged = trace.union((a, b) for _, a, b in tr.kernels)
    gaps = [(b - a) - trace.covered((a, b), merged) for a, b in tr.calls]
    return 1e3 * statistics.median(gaps)
