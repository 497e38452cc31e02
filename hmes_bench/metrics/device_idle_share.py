"""The share of the window in which no operation ran on a card, in %; on
several cards, the mean of each card's share (``ctx.busy_s`` is the mean
of each card's busy time)."""


def read(ctx):
    if not ctx.ops:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
