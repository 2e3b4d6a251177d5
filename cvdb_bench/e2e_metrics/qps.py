"""All queries completed in the window over the whole window."""


def read(ctx):
    return ctx.window["queries"] / ctx.window["seconds"]
