"""K1's share of its roofline (csrc/tiles_resid.cu), from the trace."""

from cvdb_bench import readers


def read(ctx):
    return readers.kernel_roofline_pct(ctx, "K1")
