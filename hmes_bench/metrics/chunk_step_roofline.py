"""The chunk step's share of its roofline, in %: the least time the
answers' bytes (``hbm_bytes``, a lower bound) take at the peak memory
bandwidth of the cell's cards together, over the device's busy time in
the window (every kernel, whatever does the work; each card's, their
mean)."""


def read(ctx):
    if not ctx.ops or not ctx.busy_s or ctx.bytes is None:
        return None
    return 100.0 * ctx.bytes / (ctx.chips * ctx.peaks["hbm_bytes_per_s"]) \
        / ctx.busy_s
