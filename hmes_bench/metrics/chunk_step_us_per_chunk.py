"""Device time of the kernels named ``chunk_step`` per chunk of the trace
(every design point of a launch together), in us; on several cards, the
slowest card's (its share of the points), which the answer waits for."""
from hmes_bench import devtrace


def read(ctx):
    if not ctx.ops:
        return None
    us = max(devtrace.card_us(ctx.ops, ctx.chips, "chunk_step"))
    return us / ctx.chunks if us > 0 else None
