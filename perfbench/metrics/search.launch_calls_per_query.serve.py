"""search.launch_calls_per_query.serve (calls): the host's kernel- and
graph-launch calls in the profiled slice of an open loop, per request
answered in it."""

from perfbench.yard import launches


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    names = [n for n, s, _ in tr.host if tr.lo <= s <= tr.hi]
    return launches.per_query(names, ctx.traced_queries)
