"""The 95th percentile of the time to an answer, over every answer of the
window (host clock, ms; linear between the two nearest answers)."""
import statistics


def read(ctx):
    if len(ctx.answers_ms) < 2:
        return None
    return statistics.quantiles(ctx.answers_ms, n=20, method="inclusive")[18]
