"""Device ms a batch outside the scan kernels: planner, pending scan and
merge, rotation, rescore, top-k."""

from cvdb_bench import readers


def read(ctx):
    return readers.rest_device_ms(ctx)
