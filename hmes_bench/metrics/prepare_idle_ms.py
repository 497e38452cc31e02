"""Device-idle time an answer while the program prepares kernel B, in
ms: from the start of the answer's root span (``engine.run`` /
``engine.sweep``) to the end of its ``chunk_step.enqueue`` span, the
device trace moved onto the spans' clock (``spans``). None where the
program records no spans."""
from hmes_bench import spans


def read(ctx):
    return spans.idle_ms(ctx, "prepare")
