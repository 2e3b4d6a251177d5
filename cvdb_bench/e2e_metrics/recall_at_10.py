"""recall@10 of the judged answers of the window against the exact f32
top-10 over every row the index holds."""


def read(ctx):
    return ctx.recall
