"""Device time of the kernels named ``chunk_step`` per chunk of the trace
(every design point of a launch together), in us."""


def read(ctx):
    if not ctx.ops:
        return None
    us = sum(o.end_us - o.start_us for o in ctx.ops if "chunk_step" in o.name)
    return us / ctx.chunks if us > 0 else None
