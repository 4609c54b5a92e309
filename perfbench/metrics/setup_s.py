"""setup_s (s): process start to the first timed call: the kernels' build
or load, the data and its exact neighbours, the index build and the
warm-up of the traffic's own shapes."""


def read(ctx):
    return ctx.setup_s
