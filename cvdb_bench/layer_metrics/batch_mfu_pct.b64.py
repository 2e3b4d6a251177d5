"""The search batch's share of the chip's published peak."""

from cvdb_bench import readers


def read(ctx):
    return readers.batch_mfu_pct(ctx)
