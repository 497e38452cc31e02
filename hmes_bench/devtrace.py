"""Device activity from a ``torch.profiler`` trace (CUPTI): every kernel,
copy and set on the card, the union of their intervals, and what a run's
breakdown shows."""
from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

NAME_CHARS = 120    # a kernel's name as the breakdown gives it


class DeviceOp(NamedTuple):
    name: str
    start_us: float
    end_us: float


def device_ops(prof) -> list[DeviceOp]:
    """Every device operation of a finished profile, in start order."""
    from torch.autograd import DeviceType
    ops = [DeviceOp(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    return sorted(ops, key=lambda o: o.start_us)


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
    return sum(e - s for s, e, _, _ in busy_intervals(ops)) / 1e6


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def breakdown(ops: list[DeviceOp], top: int = 10) -> dict:
    """The operations that took most device time, summed by name, and the
    idle gaps between stretches of activity, summed by the operations on
    either side (what the host did between them), each as
    [[name, seconds], ...], longest first."""
    by_op: dict[str, float] = defaultdict(float)
    for o in ops:
        by_op[_short(o.name)] += (o.end_us - o.start_us) / 1e6
    gaps: dict[str, float] = defaultdict(float)
    busy = busy_intervals(ops)
    for (_, end, _, last), (start, _, first, _) in zip(busy, busy[1:]):
        gaps[f"after {_short(last)} before {_short(first)}"] += \
            (start - end) / 1e6
    rank = lambda d: [[k, v] for k, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}
