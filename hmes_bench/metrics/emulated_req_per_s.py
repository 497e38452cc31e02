"""Emulated memory requests completed in the window, a design point each,
per second of the window, in millions (host clock)."""


def read(ctx):
    return ctx.requests / ctx.window_s / 1e6
