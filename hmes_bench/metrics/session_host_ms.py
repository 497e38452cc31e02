"""Host time of an answer: the window's time less the time in which some
card was busy (the union of every kernel, copy and set on every card),
per answer, in ms. The answers run back to back, so this is the time an
answer leaves every card idle: ``Engine.run`` / ``Engine.sweep``'s
packing, dispatch, gather and summary."""
from hmes_bench import devtrace


def read(ctx):
    if not ctx.ops:
        return None
    return (ctx.window_s - devtrace.busy_s(ctx.ops)) / len(ctx.answers_ms) \
        * 1e3
