"""The median ms of a search() call in which the card is idle while the
host copies queries in or answers out (the cvdb.search.in and
cvdb.search.out spans)."""

from cvdb_bench import spans


def read(ctx):
    return spans.copy_idle_ms(ctx)
