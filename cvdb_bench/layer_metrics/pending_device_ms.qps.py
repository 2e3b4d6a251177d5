"""Device ms a batch of the exact pending and annex scans and their merge
(index/ivf_band.py _merge_pending_topk): the device ops launched inside the
program's cvdb.pending span, idle time between them not counted; median
over traced calls."""

from cvdb_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "cvdb.pending")
