"""The share of the rows in the tiles a plan may choose that the filter
allows: 100 x the cvdb.filter span's allowed_rows over its live_rows
(live tiles x tile_n), counts the program caches per filter and arena
state."""

from cvdb_bench import spans


def read(ctx):
    allowed = spans.count(ctx, "cvdb.filter", "allowed_rows")
    live = spans.count(ctx, "cvdb.filter", "live_rows")
    if allowed is None or not live:
        return None
    return 100.0 * allowed / live
