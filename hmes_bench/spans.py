"""What the program records about itself while the profiler runs
(``repro_torch.telemetry``), for the per-layer metrics that read it: its
spans, its counters, kernel B's stage cycles, and the device's busy
intervals moved onto the spans' clock. Each function returns None where
the program records nothing: a program without that module, or an
untraced run."""
from __future__ import annotations

import bisect
from typing import NamedTuple

from hmes_bench import devtrace

ENQUEUE = "chunk_step.enqueue"
PHASE_BUFFER = "chunk_step.phases"


def recording():
    """The program's recording of the window, or None where it has
    none."""
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    rec = telemetry.recorded()
    return rec if rec.spans or rec.counters else None


class Answer(NamedTuple):
    """An answer's host times (ns, the spans' clock): its root's start,
    the end of its last kernel-B enqueue, the end of its last readout."""
    start: int
    enqueued: int
    end: int


def answers(rec) -> list[Answer]:
    """Every answer of the recording that launched kernel B, in order.
    A readout (a root with a ``cause``) ends the answer it reads; an
    answer read by none ends with its root."""
    roots, enq, ends = {}, {}, {}
    for s in rec.spans:
        if s.parent is None and s.cause is None:
            roots[s.answer] = s
        if s.name == ENQUEUE:
            enq[s.answer] = max(enq.get(s.answer, s.end_ns), s.end_ns)
        if s.cause is not None:
            ends[s.answer] = max(ends.get(s.answer, s.end_ns), s.end_ns)
    out = [Answer(r.start_ns, enq[a], max(ends.get(a, r.end_ns), r.end_ns))
           for a, r in roots.items() if a in enq]
    return sorted(out)


def busy_ns(ctx, rec) -> list[tuple[float, float]] | None:
    """The device's busy intervals of the window (``devtrace``'s union)
    on the spans' clock, in ns, or None where the recording cannot anchor
    the trace's clock (``telemetry.device_clock``)."""
    from repro_torch import telemetry
    if not ctx.ops:
        return None
    starts = [o.start_us * 1e3 for o in ctx.ops if "chunk_step" in o.name]
    to_host = telemetry.device_clock(starts, rec.spans)
    if to_host is None:
        return None
    return [(to_host(s * 1e3), to_host(e * 1e3))
            for s, e, _, _ in devtrace.busy_intervals(ctx.ops)]


def idle_ns(busy: list[tuple[float, float]], lo: float, hi: float) -> float:
    """The time within [lo, hi] in which no interval of ``busy`` (sorted,
    disjoint) runs."""
    if hi <= lo:
        return 0.0
    k = max(bisect.bisect_right(busy, (lo,)) - 1, 0)
    covered = 0.0
    for s, e in busy[k:]:
        if s >= hi:
            break
        covered += max(0.0, min(e, hi) - max(s, lo))
    return (hi - lo) - covered


def idle_ms(ctx, part: str) -> float | None:
    """Device-idle time an answer, in ms, from its root's start to the end
    of its kernel-B enqueue (``part`` "prepare") or from there to the end
    of its last readout ("readout")."""
    rec = recording()
    if rec is None:
        return None
    todo = answers(rec)
    busy = busy_ns(ctx, rec) if todo else None
    if busy is None:
        return None
    span = (lambda a: (a.start, a.enqueued)) if part == "prepare" else \
        (lambda a: (a.enqueued, a.end))
    return sum(idle_ns(busy, *span(a)) for a in todo) / len(todo) / 1e6


def phase_us(ctx, phase: str) -> float | None:
    """Kernel B's stage ``phase``: its share of the leading CTAs' cycles
    in the window times the window's ``chunk_step`` device time per chunk
    (the nine together are ``chunk_step_us_per_chunk``), in us. On
    several cards, the slowest card's: its cycles (the buffers the
    program keeps on that card) and its time; None where that card's
    buffers hold no cycles."""
    rec = recording()
    if rec is None or not ctx.ops:
        return None
    import torch

    from repro_torch.kernels.chunk_step import PHASES
    us = devtrace.card_us(ctx.ops, ctx.chips, "chunk_step")
    card = max(range(len(us)), key=us.__getitem__)
    cycles = [0] * len(PHASES)
    for key, buf in rec.buffers.items():
        if key[0] == PHASE_BUFFER and (
                ctx.chips == 1 or torch.device(key[1]).index == card):
            for k, c in enumerate(buf.sum(dim=0).tolist()):
                cycles[k] += c
    total = sum(cycles)
    if total <= 0 or us[card] <= 0:
        return None
    return cycles[PHASES.index(phase)] / total * us[card] / ctx.chunks
