"""Process start to the first timed answer: imports, the kernels' build or
load, the traces, the engine and one warm-up answer a trace (host clock,
s)."""


def read(ctx):
    return ctx.setup_s
