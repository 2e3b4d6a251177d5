"""Device ms a batch of the planner (index/ivf_band.py _plan_tiles): the
device ops launched inside the program's cvdb.plan span, idle time between
them not counted; median over traced calls."""

from cvdb_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "cvdb.plan")
