"""The median host-clock ms of a search() call that no device op covers."""

from cvdb_bench import readers


def read(ctx):
    return readers.host_gap_ms(ctx)
