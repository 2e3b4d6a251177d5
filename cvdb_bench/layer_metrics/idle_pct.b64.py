"""The card's idle share of the traced window."""

from cvdb_bench import readers


def read(ctx):
    return readers.idle_pct(ctx)
