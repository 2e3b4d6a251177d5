"""torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start: index and scratch, in GiB."""


def read(ctx):
    return None if ctx.serve_peak_bytes is None else ctx.serve_peak_bytes / 2**30
