"""Device ms a batch of the filter's work outside K1 (index/ivf_band.py
_tiles_kernel_dispatch, filtered branch): the device ops launched inside
the program's cvdb.filter span (the cached arena-mask lookup and the plan's
live tiles), idle time between them not counted; median over traced
calls."""

from cvdb_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "cvdb.filter")
