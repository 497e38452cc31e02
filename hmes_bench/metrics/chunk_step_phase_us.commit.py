"""Kernel B's stage ``commit``, in us a chunk: its share of the leading CTAs'
clock64() cycles (the program's stamped launches) times the window's
``chunk_step`` device time per chunk. None where the program records no
stage cycles."""
from hmes_bench import spans


def read(ctx):
    return spans.phase_us(ctx, "commit")
