"""The whole answer's share of the cell's cards' peak, in %: the least
time the answers' bytes (``hbm_bytes``) take at the peak memory bandwidth
of every card together, over the answers' own time (host clock). The
emulation is integer work with no floating-point operations to count, so
its peak is memory bandwidth."""


def read(ctx):
    if not ctx.ops or ctx.bytes is None:
        return None
    return 100.0 * ctx.bytes / (ctx.chips * ctx.peaks["hbm_bytes_per_s"]) \
        / (sum(ctx.answers_ms) / 1e3)
