"""Device ms a batch of the int8 rescore (index/ivf_band.py _pq_tiles_core):
the device ops launched inside the program's cvdb.rescore span, idle time
between them not counted; median over traced calls."""

from cvdb_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "cvdb.rescore")
