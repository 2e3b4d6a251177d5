"""The 95th percentile (nearest rank) of every call's host-clock latency in
the window."""

from cvdb_bench import readers


def read(ctx):
    return readers.percentile(ctx.window["latencies_ms"], 95.0)
