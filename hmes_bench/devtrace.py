"""Device activity from a ``torch.profiler`` trace (CUPTI): every kernel,
copy and set on each card, the union of their intervals, and what a run's
breakdown shows."""
from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

NAME_CHARS = 120    # a kernel's name as the breakdown gives it


class DeviceOp(NamedTuple):
    name: str
    start_us: float
    end_us: float
    device: int = 0     # the card's index (``cuda:<device>``)


def device_ops(prof) -> list[DeviceOp]:
    """Every device operation of a finished profile, on every card, in
    start order."""
    from torch.autograd import DeviceType
    ops = [DeviceOp(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
                    e.device_index())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    return sorted(ops, key=lambda o: o.start_us)


def by_card(ops: list[DeviceOp], chips: int) -> list[list[DeviceOp]]:
    """The operations of each of cards 0..chips-1, in the order given (on
    one card, ``ops`` itself)."""
    if chips == 1:
        return [ops]
    return [[o for o in ops if o.device == c] for c in range(chips)]


def busy_intervals(ops: list[DeviceOp]) -> list[tuple[float, float, str, str]]:
    """The union of the operations' intervals: (start, end, first op,
    last op) a stretch of activity, in order."""
    out: list[list] = []
    for o in ops:
        if out and o.start_us <= out[-1][1]:
            if o.end_us > out[-1][1]:
                out[-1][1], out[-1][3] = o.end_us, o.name
        else:
            out.append([o.start_us, o.end_us, o.name, o.name])
    return [tuple(x) for x in out]


def busy_s(ops: list[DeviceOp]) -> float:
    """Seconds in which at least one of ``ops`` ran."""
    return sum(e - s for s, e, _, _ in busy_intervals(ops)) / 1e6


def mean_busy_s(ops: list[DeviceOp], chips: int) -> float:
    """Each card's busy seconds, their mean over the ``chips`` cards (a
    card that ran nothing counts 0)."""
    return sum(busy_s(c) for c in by_card(ops, chips)) / chips


def card_us(ops: list[DeviceOp], chips: int, part: str) -> list[float]:
    """Each card's device time, in us, of the operations whose name holds
    ``part``."""
    return [sum(o.end_us - o.start_us for o in card if part in o.name)
            for card in by_card(ops, chips)]


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def breakdown(ops: list[DeviceOp], chips: int = 1, top: int = 10) -> dict:
    """The operations that took most device time, summed by name over the
    cards, and the idle gaps between stretches of a card's activity,
    summed by the operations on either side (what the host did between
    them; on several cards named by card too), each as [[name, seconds],
    ...], longest first."""
    by_op: dict[str, float] = defaultdict(float)
    for o in ops:
        by_op[_short(o.name)] += (o.end_us - o.start_us) / 1e6
    gaps: dict[str, float] = defaultdict(float)
    for c, card in enumerate(by_card(ops, chips)):
        where = "" if chips == 1 else f"cuda:{c} "
        busy = busy_intervals(card)
        for (_, end, _, last), (start, _, first, _) in zip(busy, busy[1:]):
            gaps[f"{where}after {_short(last)} before {_short(first)}"] += \
                (start - end) / 1e6
    rank = lambda d: [[k, v] for k, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}
