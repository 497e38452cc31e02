"""Spans and counters of the port: where an answer's host time goes.

    from torch.profiler import ProfilerActivity, profile
    from repro_torch import telemetry

    cpu, cuda = ProfilerActivity.CPU, ProfilerActivity.CUDA
    with profile(activities=[cpu, cuda]) as p:
        row = engine.run(trace).summary()
    p.export_chrome_trace("trace.json")     # spans above the kernels
    rec = telemetry.recorded()              # spans, counters, device buffers
    telemetry.clear()

**The switch is the profiler.** The module records exactly while a
``torch.profiler`` session records in this process
(``torch.autograd._profiler_enabled()``); there is no flag of its own.
Otherwise :func:`span` is one check and a thread-local flag, and
returns a shared object doing nothing, and :func:`count` is one check:
no allocation, no device operation and no synchronisation.

**Spans.** ``with span(name, **attrs):`` records, when it closes, a
:class:`Span`: its id, its parent's (the span open around it on the same
thread, None for a root), its answer's, its name, start and end
(``time.time_ns()``, taken outside the span's own bookkeeping, so that
what recording costs lies inside it) and its attributes. It also opens a
``torch.profiler.record_function(name)`` range, so a trace exported with
CPU activity shows the program's stages above the kernels they launch. A
root starts an answer (its id is the answer's id) and its children share
it. A readout (:data:`READOUTS`: the host-side summaries a caller reads
after a run) opened as a root belongs to the answer of the last
``engine.*`` root closed on its thread, its ``cause``.

**Recordings.** A span recorded on a thread that opened a span while
nothing recorded since its last recorded one starts a new recording:
what the last one held is dropped. So :func:`recorded` holds the latest
stretch of recording (a profiler session), until :func:`clear`.

**Counters** (:func:`count`) are sums over the recording;
:func:`buffer` holds device tensors a recording accumulates into (kernel
B's clock64() stage split), made on first use and never read while the
recording runs.

**Clocks.** CUPTI stamps the device's operations on a clock that is
not the host's ``time.time_ns()``: on the H100 measured it sat 10-50 us
off it through a 20 s recording, and drifted by 0.05-1.6% through
recordings of a fifth of a second. :func:`device_clock` maps the device
trace onto the spans' clock from anchors the recording holds: each
kernel-B launch's host time against that kernel's start in the trace.
"""
from __future__ import annotations

import itertools
import statistics
import threading
import time
from typing import Callable, NamedTuple, Sequence

import torch

# The summaries read after a run: a root of one of these names belongs to
# the answer it reads.
READOUTS = frozenset({"counters.summary", "sweep.rows"})

_recording = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """One closed span (times in ``time.time_ns()`` nanoseconds)."""
    id: int
    parent: int | None     # the enclosing span on the thread; None: a root
    answer: int            # the id of the answer's first root
    name: str
    start_ns: int
    end_ns: int
    attrs: dict
    cause: int | None      # a readout root: the engine root it reads


class Recording(NamedTuple):
    """What :func:`recorded` returns: the closed spans in closing order,
    the counters, and the device buffers by key."""
    spans: tuple
    counters: dict
    buffers: dict


_ids = itertools.count(1)
_spans: list[Span] = []
_counters: dict[str, int] = {}
_buffers: dict = {}
class _Thread(threading.local):
    """A thread's open spans, its last engine root closed (id, answer),
    and whether it opened a span while nothing recorded since its last
    recorded one."""
    last_root = None
    between = False

    def __init__(self):
        self.stack = []


_local = _Thread()


class _Off:
    """The span while nothing records: enters and leaves, records
    nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


class _Open:
    """A span being recorded."""
    __slots__ = ("name", "attrs", "id", "parent", "answer", "cause",
                 "start_ns", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __bool__(self):
        return True

    def set(self, **attrs) -> None:
        """Add attributes (known only once the work has run)."""
        self.attrs.update(attrs)

    def __enter__(self):
        self.start_ns = time.time_ns()
        st = _local.stack
        self.id = next(_ids)
        self.cause = None
        if st:
            self.parent, self.answer = st[-1].id, st[-1].answer
        else:
            self.parent, self.answer = None, self.id
            last = _local.last_root
            if self.name in READOUTS and last is not None:
                self.cause, self.answer = last
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        st.append(self)
        return self

    def __exit__(self, et, ev, tb):
        _local.stack.pop()
        self._range.__exit__(et, ev, tb)
        _spans.append(Span(self.id, self.parent, self.answer, self.name,
                           self.start_ns, time.time_ns(), self.attrs,
                           self.cause))
        if self.parent is None and self.name.startswith("engine."):
            _local.last_root = (self.id, self.answer)
        return False


def span(name: str, **attrs):
    """A context manager that records the work inside it as span
    ``name`` while a profiler records; otherwise :data:`OFF`. The object
    entered is true when recording, and takes further attributes through
    ``set(**attrs)``."""
    if not _recording():
        _local.between = True
        return OFF
    if _local.between:
        _local.between = False
        _forget()
    return _Open(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if _recording():
        _counters[name] = _counters.get(name, 0) + n


def buffer(key, make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The recording's device tensor under ``key`` (a tuple whose first
    item names it), made by ``make()`` on first use. Call only while
    recording; read only once the recording has ended."""
    t = _buffers.get(key)
    if t is None:
        t = _buffers[key] = make()
    return t


def recorded() -> Recording:
    """The spans, counters and buffers of the latest recording."""
    return Recording(tuple(_spans), dict(_counters), dict(_buffers))


def _forget() -> None:
    _spans.clear()
    _counters.clear()
    _buffers.clear()


def clear() -> None:
    """Forget what was recorded (and this thread's last root)."""
    _forget()
    _local.last_root = None


# The span whose ``launch_ns`` attribute, (before, after) the host's call
# that enqueues kernel B, anchors the device trace's clock.
LAUNCH_SPAN = "chunk_step.enqueue"


def device_clock(starts_ns: Sequence[float], spans: Sequence[Span]
                 ) -> Callable[[float], float] | None:
    """A map from the device trace's clock onto the spans' (ns to ns), or
    None where the recording cannot anchor it.

    ``starts_ns``: the start, in the device trace, of every kernel-B
    launch of the recording. The k-th (in time order) is paired with the
    k-th recorded :data:`LAUNCH_SPAN` span: its host time is the return of
    the call that enqueued it, which on an idle device is the kernel's
    start within tens of microseconds. The map adds to a device time the
    line fitted to the anchors' offsets (host less device) against device
    time; an anchor whose offset lies off the line by more than
    :data:`ANCHOR_SLACK_NS` and four deviations (the host held up after
    the enqueue, or the device busy before it) is left out and the line
    fitted again. One anchor gives a constant offset. None when the
    counts differ or there is no anchor."""
    host = sorted(s.attrs["launch_ns"][1] for s in spans
                  if s.name == LAUNCH_SPAN and "launch_ns" in s.attrs)
    dev = sorted(starts_ns)
    if not dev or len(dev) != len(host):
        return None
    base = dev[0]
    xs = [d - base for d in dev]
    offs = [h - d for h, d in zip(host, dev)]
    keep = range(len(xs))
    for _ in range(3):
        a, b = _line([xs[k] for k in keep], [offs[k] for k in keep])
        res = [o - (a + b * x) for x, o in zip(xs, offs)]
        spread = statistics.median(abs(res[k]) for k in keep)
        cut = max(ANCHOR_SLACK_NS, 4 * 1.4826 * spread)
        kept = [k for k in range(len(xs)) if abs(res[k]) <= cut]
        if len(kept) < 2 or kept == list(keep):
            break
        keep = kept
    return lambda t: t + a + b * (t - base)


# How far an anchor's offset may lie off the fitted line and still count.
ANCHOR_SLACK_NS = 20_000


def _line(xs: list[float], ys: list[float]) -> tuple[float, float]:
    """(a, b) of the least-squares line y = a + b x (b = 0 for one x)."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    if sxx == 0:
        return my, 0.0
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    return my - b * mx, b


__all__ = ["Recording", "Span", "READOUTS", "LAUNCH_SPAN", "OFF", "buffer",
           "clear", "count", "device_clock", "recorded", "span"]
