"""The device trace of a short steady sub-window: ``torch.profiler`` with
CPU and CUDA activities, reduced to kernel intervals, the host's call
spans, the card's busy time (the union of every device operation's
interval), kernel time by name and the longest idle gaps named by what the
host was doing in them (the method of ``chip_smoke.py::device_profile``,
copied here with the interval arithmetic added)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

CALL = "cvdb_call"  # the record_function name of one call into the program
WINDOW = "cvdb_window"


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    n_calls: int = 0
    kernels: list = field(default_factory=list)  # (name, start_s, end_s) device ops
    calls: list = field(default_factory=list)  # (start_s, end_s) of each call
    host_ops: list = field(default_factory=list)  # (name, start_s, end_s) CPU ops

    def kernel_s(self, match=None, exclude=()) -> float:
        """Seconds of the device ops whose name holds one of ``match``
        (every op when None) and none of ``exclude``."""
        tot = 0.0
        for name, a, b in self.kernels:
            if match is not None and not any(m in name for m in match):
                continue
            if any(x in name for x in exclude):
                continue
            tot += b - a
        return tot

    def has(self, match) -> bool:
        return any(any(m in name for m in match) for name, _, _ in self.kernels)


def union(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(span, merged) -> float:
    """Seconds of ``span`` that the disjoint intervals ``merged`` cover."""
    a, b = span
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)


def profile(body, dev: torch.device) -> Trace:
    """Run ``body()`` (which wraps each call in ``torch.profiler.
    record_function(CALL)``) under the profiler, fenced, inside a
    ``WINDOW`` span; return its reduced Trace."""
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    with _profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            n_calls = body()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
    tr = Trace(n_calls=n_calls)
    win = None
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        on_card = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name in (WINDOW, CALL):
            if on_card:  # the annotations' device-side copies are no device ops
                continue
            if e.name == WINDOW:
                win = (a, b)
            else:
                tr.calls.append((a, b))
        elif on_card:
            tr.kernels.append((e.name, a, b))
        else:
            tr.host_ops.append((e.name, a, b))
    tr.window_s = (win[1] - win[0]) if win else wall
    merged = union((a, b) for _, a, b in tr.kernels)
    tr.busy_s = covered(win, merged) if win else sum(b - a for a, b in merged)
    tr.calls.sort()
    return tr


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device ops that took most time, by name, and the longest idle
    gaps of the card within the window, each named by the innermost host
    op that covers most of it ('host' when none does)."""
    by_name: dict = {}
    for name, a, b in tr.kernels:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    merged = union((a, b) for _, a, b in tr.kernels)
    lo = tr.calls[0][0] if tr.calls else (merged[0][0] if merged else 0.0)
    hi = tr.calls[-1][1] if tr.calls else (merged[-1][1] if merged else 0.0)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    spans = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                   key=lambda g: g[0] - g[1])[:top]
    for a, b in spans:
        best, name, size = 0.0, "host", float("inf")
        for hn, x, y in tr.host_ops:
            ov = min(b, y) - max(a, x)
            if ov > best or (ov == best > 0 and y - x < size):
                best, name, size = ov, hn, y - x
        gaps.append([name[:120], b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps[:top]}
