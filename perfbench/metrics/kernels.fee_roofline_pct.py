"""kernels.fee_roofline_pct (%): the least time the card needs for the
profiled calls' FEE scoring work, over the device time of the kernels that
do it.

The work is what the inputs need, whatever implements it
(``yard/fee_bytes.py``): the lanes scored and the dims they touched, from
the program's counters, at the storage's bytes a dim.  The least time is
the larger of bytes over HBM bandwidth and operations over float32 compute
(``yard/peaks.py``).  The device time is that of the kernels named below,
as the profiler reports them.
"""

from perfbench.yard import fee_bytes, peaks

KERNELS = ("fee_f32_kernel", "fee_packed_kernel", "fee_skipdma_f32_kernel",
           "fee_skipdma_packed_kernel", "fee_tiered_kernel")


def read(ctx):
    tr, c = ctx.trace, ctx.counters
    if tr is None or c.get("search.lanes_evaluated", 0) <= 0:
        return None
    busy_s = sum(e - s for n, s, e in tr.device
                 if any(k in n for k in KERNELS)) / 1e9
    if busy_s <= 0:
        return None
    bpd = fee_bytes.bytes_per_dim(ctx.storage, ctx.layout_bits, ctx.dim)
    n_bytes, n_flops = fee_bytes.fee_work(
        c["search.lanes_evaluated"], c["search.dims_touched"],
        c["search.queries"], ctx.dim, bpd, ctx.metric)
    least_s, _ = peaks.least_seconds(n_bytes, n_flops)
    return 100.0 * least_s / busy_s
