"""Host time of an answer: the window's time less the device's busy time
(the union of every kernel, copy and set), per answer, in ms. The answers
run back to back, so this is the time an answer leaves the card idle:
``Engine.run`` / ``Engine.sweep``'s packing, dispatch and summary."""


def read(ctx):
    if not ctx.ops:
        return None
    return (ctx.window_s - ctx.busy_s) / len(ctx.answers_ms) * 1e3
