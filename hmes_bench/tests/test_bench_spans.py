"""The readers of what the program records about itself (``spans``):
idle time inside an interval, answers split at kernel B's enqueue on a
drifting device clock, a readout that ends its answer, None where the
program records nothing, the waves counter, and the stage split summing
to ``chunk_step_us_per_chunk``."""
import pathlib
import sys

import pytest
import torch

from hmes_bench import devtrace, discover, harness, spans
from repro_torch import telemetry

ROOT = pathlib.Path(__file__).resolve().parents[2]
PHASES = ("load", "rx", "redirect", "stage345", "commit", "satw", "decay",
          "retire", "policy")
PROGRAM = ["prepare_idle_ms", "readout_idle_ms", "chunk_step_waves",
           *(f"chunk_step_phase_us.{p}" for p in PHASES)]
MS = 1_000_000   # ns


def read(name, ctx):
    return discover.reader(ROOT, name).read(ctx)


def ctx_of(ops, chunks=10):
    return harness.Context(
        setup_s=1.0, window_s=1.0, answers_ms=[1.0, 1.0], requests=1,
        chunks=chunks, peaks={}, ops=ops,
        busy_s=devtrace.busy_s(ops) if ops else None)


def sp(id, parent, answer, name, start, end, cause=None, **attrs):
    return telemetry.Span(id, parent, answer, name, start, end, attrs, cause)


@pytest.fixture
def recording(monkeypatch):
    """Make the program's recording the one a test gives."""
    def give(spans=(), counters=None, buffers=None):
        rec = telemetry.Recording(tuple(spans), counters or {}, buffers or {})
        monkeypatch.setattr(telemetry, "recorded", lambda: rec)
    return give


def test_idle_inside_an_interval():
    busy = [(10.0, 20.0), (30.0, 40.0)]
    assert spans.idle_ns(busy, 0, 50) == 30
    assert spans.idle_ns(busy, 15, 35) == 10
    assert spans.idle_ns(busy, 21, 29) == 8
    assert spans.idle_ns(busy, 12, 18) == 0
    assert spans.idle_ns(busy, 45, 50) == 5
    assert spans.idle_ns(busy, 50, 45) == 0
    assert spans.idle_ns([], 3, 7) == 4


def _answer(k, t0, dev, **readout):
    """Answer ``k`` from host time ``t0`` (ms): root 0-10 ms; pad_trace
    0-1; enqueue 2-4, kernel B launched at 4; the root ends at 10; its
    readout 10-12 (or as ``readout`` says). Its device operations on the
    device clock ``dev``: a copy 1-1.5 ms, kernel B 4-9, a copy 11-11.5."""
    ms = lambda x: int((t0 + x) * MS)
    a = 100 * k + 1
    rd = readout.get("readout", (10, 12))
    out = [sp(a, None, a, "engine.run", ms(0), ms(10)),
           sp(a + 1, a, a, "emulator.pad_trace", ms(0), ms(1)),
           sp(a + 2, a, a, "chunk_step.enqueue", ms(2), ms(4),
              launch_ns=(ms(3.9), ms(4)))]
    if rd is not None:
        out.append(sp(a + 3, None, a, "counters.summary", ms(rd[0]),
                      ms(rd[1]), cause=a))
    ops = [devtrace.DeviceOp("copy", dev(t0 + 1) / 1e3,
                             dev(t0 + 1.5) / 1e3),
           devtrace.DeviceOp("chunk_step_kernel<false, true>",
                             dev(t0 + 4) / 1e3, dev(t0 + 9) / 1e3),
           devtrace.DeviceOp("copy", dev(t0 + 11) / 1e3,
                             dev(t0 + 11.5) / 1e3)]
    return out, ops


# The device trace's clock against the host's: 3 ms behind and 0.4% slow
# (the line through two anchors or more follows the rate), or only shifted
# (one anchor). A trace's times near 1.7e18 ns carry a quarter of a
# microsecond.
def drifting(ms):
    return (ms * MS - 3 * MS) * 0.996 + 1.7e18


def shifted(ms):
    return ms * MS - 3 * MS + 1.7e18


US = 1e-3   # ms


def test_answers_split_at_the_enqueue_on_a_drifting_clock(recording):
    s0, o0 = _answer(0, 0.0, drifting)
    s1, o1 = _answer(1, 12.02, drifting)
    recording(s0 + s1)
    ctx = ctx_of(o0 + o1)
    # Prepare: 0-4 ms less the copy's 0.5; readout: 4-12 less kernel B's
    # 5 and the copy's 0.5.
    assert read("prepare_idle_ms", ctx) == pytest.approx(3.5, abs=US)
    assert read("readout_idle_ms", ctx) == pytest.approx(2.5, abs=US)


def test_a_readout_ends_its_answer(recording):
    late, ops = _answer(0, 0.0, shifted, readout=(10, 15))
    recording(late)
    assert read("readout_idle_ms", ctx_of(ops)) == pytest.approx(5.5, abs=US)
    alone, ops = _answer(0, 0.0, shifted, readout=None)
    recording(alone)
    # No readout: the answer ends with its root, at 10 ms.
    assert read("readout_idle_ms", ctx_of(ops)) == pytest.approx(1.0, abs=US)
    assert read("prepare_idle_ms", ctx_of(ops)) == pytest.approx(3.5, abs=US)


def test_none_without_spans(recording, monkeypatch):
    _, ops = _answer(0, 0.0, drifting)
    recording()
    for name in PROGRAM:
        assert read(name, ctx_of(ops)) is None, name
    # A program without the module: the parent commit's.
    import repro_torch
    monkeypatch.delattr(repro_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
    for name in PROGRAM:
        assert read(name, ctx_of(ops)) is None, name


def test_none_where_the_trace_cannot_be_anchored(recording):
    s0, o0 = _answer(0, 0.0, drifting)
    s1, _ = _answer(1, 12.02, drifting)
    recording(s0 + s1)
    for name in ("prepare_idle_ms", "readout_idle_ms"):
        assert read(name, ctx_of(o0)) is None
        assert read(name, ctx_of([])) is None


def test_waves_a_launch(recording):
    recording(counters={"chunk_step.launches": 3, "chunk_step.waves": 5})
    assert read("chunk_step_waves", ctx_of([])) == pytest.approx(5 / 3)
    recording(counters={"chunk_step.launches": 0})
    assert read("chunk_step_waves", ctx_of([])) is None


def test_phase_metrics_sum_to_chunk_step_us_per_chunk(recording):
    cycles = torch.tensor([[9, 1, 2, 20, 3, 1, 5, 6, 8],
                           [7, 2, 1, 18, 4, 0, 6, 5, 9]], dtype=torch.int64)
    recording(spans=[sp(1, None, 1, "engine.sweep", 0, 1)],
              buffers={("chunk_step.phases", "cuda:0", 2): cycles,
                       ("other", "cuda:0", 2): cycles * 100})
    ops = [devtrace.DeviceOp("chunk_step_kernel<false, true>", 0.0, 700.0),
           devtrace.DeviceOp("copy", 700.0, 900.0),
           devtrace.DeviceOp("chunk_step_kernel<false, true>", 1000.0,
                             1350.0)]
    ctx = ctx_of(ops, chunks=50)
    per = {p: read(f"chunk_step_phase_us.{p}", ctx) for p in PHASES}
    whole = read("chunk_step_us_per_chunk", ctx)
    assert whole == pytest.approx(21.0)
    assert sum(per.values()) == pytest.approx(whole, rel=1e-12)
    assert per["stage345"] == pytest.approx(38 / 107 * 21.0)
    assert per["satw"] == pytest.approx(1 / 107 * 21.0)
