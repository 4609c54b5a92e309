"""qps (queries/s): every query a closed loop completed in the window, over
the window's wall time from its start to the last completion."""


def read(ctx):
    if ctx.loop != "closed" or not ctx.calls:
        return None
    return sum(len(c[0]) for c in ctx.calls) / ctx.window_s
