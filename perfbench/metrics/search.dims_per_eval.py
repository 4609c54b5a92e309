"""search.dims_per_eval (dims): feature dims touched per scored lane, the
FEE exit, from the program's counters (``search.dims_touched`` over
``search.lanes_evaluated``, ``index/backends.py::_record_search``) over the
profiled calls."""


def read(ctx):
    lanes = ctx.counters.get("search.lanes_evaluated", 0)
    if lanes <= 0:
        return None
    return ctx.counters["search.dims_touched"] / lanes
