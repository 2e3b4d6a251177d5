"""The scan kernels' issued tile bytes a batch (the cvdb.scan spans'
tile_read_bytes) over their device time a batch in the trace, in TB/s: a
rate, not a share of a peak (L2 hits can carry it past the HBM rate)."""

from cvdb_bench import spans


def read(ctx):
    return spans.scan_issued_tbs(ctx)
