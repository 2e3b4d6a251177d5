"""Whole-tile reads a batch that the scan kernels' grids schedule (K1, K5):
the tile_reads of the program's cvdb.scan spans."""

from cvdb_bench import spans


def read(ctx):
    return spans.count(ctx, "cvdb.scan", "tile_reads")
