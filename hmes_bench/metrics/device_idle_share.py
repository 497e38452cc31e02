"""The share of the window in which no operation ran on the device, in
%."""


def read(ctx):
    if not ctx.ops:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
