"""Device kernels, copies and sets the profiler records an answer, on
every card of the cell (the window's total over its answers)."""


def read(ctx):
    if not ctx.ops:
        return None
    return len(ctx.ops) / len(ctx.answers_ms)
