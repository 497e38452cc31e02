"""Device-idle time an answer from kernel B's enqueue to the answer, in
ms: from the end of the answer's ``chunk_step.enqueue`` span to the end
of its last readout span (``counters.summary`` / ``sweep.rows``), the
device trace moved onto the spans' clock (``spans``). With
``prepare_idle_ms`` it splits ``session_host_ms`` at the launch. None
where the program records no spans."""
from hmes_bench import spans


def read(ctx):
    return spans.idle_ms(ctx, "readout")
