"""Rounds of resident clusters a kernel-B launch takes, the mean over the
window's launches on every card: the program's counters
``chunk_step.waves`` (each launch's ceil(points / resident clusters),
``cudaOccupancyMaxActiveClusters``) over ``chunk_step.launches``. None
where the program counts nothing."""
from hmes_bench import spans


def read(ctx):
    rec = spans.recording()
    launches = 0 if rec is None else rec.counters.get("chunk_step.launches", 0)
    if not launches:
        return None
    return rec.counters["chunk_step.waves"] / launches
