"""Seconds of the index build (build_device_streaming), host clock, fenced."""


def read(ctx):
    return ctx.build_s
