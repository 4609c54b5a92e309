"""recall_at_10 (fraction): over every query answered in the window, the
share of its first 10 ids among the reference's exact first 10."""


def read(ctx):
    return ctx.recall_at.get(10)
