"""Seconds from process start to the window: imports, the card, kernel
builds (first run of a checkout), the index build, added rows, warm-up."""


def read(ctx):
    return ctx.setup_s
