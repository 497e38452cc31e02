"""``repro_torch.telemetry``: the port's spans and counters.

On the CPU: nothing records and nothing is allocated while no profiler
records; under a CPU ``torch.profiler`` the Engine's run and sweep give
their span trees (parents, answers, readouts caused by their call), on
the chunk loop and on the one-launch route; outputs are bit for bit the
same with recording on and off; the waves arithmetic and the device
clock's anchors. On the card (``cuda``): every device operation lies in
its answer, a 16-point sweep's waves, kernel B's stage cycles, and the
stamped launch's outputs equal the release launch's.
"""
import threading
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch
from repro_torch import telemetry
from repro_torch.core import paper_platform, small_platform
from repro_torch.kernels import chunk_step as tcs
from repro_torch.sweep import SweepSpec
from repro_torch.trace.generators import TraceSpec, generate

RUN_CHILDREN = ["emulator.pad_trace", "emulator.init_state",
                "emulator.chunk_loop", "emulator.unpack"]
SWEEP_CHILDREN = ["sweep.build_points", "sweep.stack_params",
                  "emulator.pad_trace", "emulator.init_states",
                  "emulator.chunk_loop", "emulator.unpack", "engine.gather"]


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.clear()
    yield
    telemetry.clear()


def _trace(n=100, seed=3, device=None, pages=60):
    return generate(TraceSpec(n_requests=n, footprint_pages=pages,
                              seed=seed), device=device)


def _spec(cfg):
    return SweepSpec(cfg, technologies=("3dxpoint", "stt-ram"),
                     policies=("hotness", "static"))


def _recorded(fn):
    """Run ``fn`` under a CPU profiler; (its result, the recording, the
    names of the profiler's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    return out, telemetry.recorded(), names


def _tree(rec):
    """{root name: (root, [children in start order], [readouts])}, one
    answer each."""
    out = {}
    for root in (s for s in rec.spans if s.parent is None and s.cause is None):
        kids = sorted((s for s in rec.spans if s.parent == root.id),
                      key=lambda s: s.start_ns)
        reads = [s for s in rec.spans if s.cause == root.id]
        out[root.name] = (root, kids, reads)
    return out


def _leaves(x):
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _leaves(v)]
    return [x]


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False


def _peak(fn) -> int:
    fn()
    tracemalloc.start()
    try:
        fn()
        return tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


def test_off_records_nothing_and_allocates_nothing():
    assert telemetry.span("a") is telemetry.span("b") is telemetry.OFF
    assert not telemetry.OFF
    null = _Null()

    def spans():
        for _ in range(2000):
            with telemetry.span("engine.run") as sp:
                telemetry.count("chunk_step.launches")
                if sp:
                    raise AssertionError("a span recorded")

    def bare():
        for _ in range(2000):
            with null as sp:
                if sp is None:
                    raise AssertionError

    assert _peak(spans) <= _peak(bare)
    cfg = small_platform()
    eng = repro_torch.Engine(cfg, device="cpu")
    eng.run(_trace()).summary()
    eng.sweep(_spec(cfg), _trace()).rows()
    rec = telemetry.recorded()
    assert rec.spans == () and rec.counters == {} and rec.buffers == {}


def test_run_span_tree_on_the_cpu():
    eng = repro_torch.Engine(small_platform(), device="cpu")
    (_, summary), rec, names = _recorded(
        lambda: (eng.run(_trace()), eng.run(_trace(seed=4)).summary()))
    roots = [s for s in rec.spans if s.parent is None and s.cause is None]
    assert [r.name for r in roots] == ["engine.run"] * 2
    first, second = sorted(roots, key=lambda s: s.start_ns)
    for root in roots:
        kids = sorted((s for s in rec.spans if s.parent == root.id),
                      key=lambda s: s.start_ns)
        assert [k.name for k in kids] == RUN_CHILDREN
        for k in kids:
            assert k.answer == root.id == root.answer
            assert root.start_ns <= k.start_ns <= k.end_ns <= root.end_ns
    reads = [s for s in rec.spans if s.cause is not None]
    assert [(r.name, r.cause, r.answer, r.parent) for r in reads] == [
        ("counters.summary", second.id, second.id, None)]
    assert reads[0].start_ns >= second.end_ns
    assert summary["reads_fast"] + summary["reads_slow"] > 0
    assert set(RUN_CHILDREN) | {"engine.run", "counters.summary"} <= names


def test_sweep_span_tree_on_the_cpu():
    cfg = small_platform()
    eng = repro_torch.Engine(cfg, device="cpu")
    rows, rec, names = _recorded(
        lambda: eng.sweep(_spec(cfg), _trace()).rows())
    tree = _tree(rec)
    assert set(tree) == {"engine.sweep"}
    root, kids, reads = tree["engine.sweep"]
    assert [k.name for k in kids] == SWEEP_CHILDREN
    assert all(k.answer == root.id for k in kids)
    assert [(r.name, r.answer) for r in reads] == [("sweep.rows", root.id)]
    assert len(rows) == 4
    assert set(SWEEP_CHILDREN) | {"engine.sweep", "sweep.rows"} <= names


def _plain_route(monkeypatch):
    """The one-launch route on the CPU: kernel B's launch replaced by its
    plain version, the ``chunk_step.enqueue`` span around it kept. (The
    plain version's module loads the JAX package, which the card's tests
    leave alone: imported here, on the CPU only.)"""
    from test_torch_scan import plain_kernel
    monkeypatch.setattr(tcs, "use_chunk_step_kernel", lambda c, t: True)
    monkeypatch.setattr(
        tcs, "_chunk_step_cuda",
        lambda sp, *a: plain_kernel(*a[:-2], phases=a[-2], cluster=a[-1]))


def test_kernel_route_span_trees(monkeypatch):
    _plain_route(monkeypatch)
    cfg = small_platform()
    eng = repro_torch.Engine(cfg, device="cpu")
    _, rec, _ = _recorded(lambda: (eng.run(_trace()).summary(),
                                   eng.sweep(_spec(cfg), _trace()).rows()))
    tree = _tree(rec)
    launch = ["chunk_step.pack", "chunk_step.enqueue", "emulator.unpack"]
    assert [k.name for k in tree["engine.run"][1]] == \
        ["emulator.pad_trace", "emulator.init_state", *launch]
    assert [k.name for k in tree["engine.sweep"][1]] == \
        ["sweep.build_points", "sweep.stack_params", "emulator.pad_trace",
         "emulator.init_states", *launch, "engine.gather"]
    for name, read in (("engine.run", "counters.summary"),
                       ("engine.sweep", "sweep.rows")):
        root, kids, reads = tree[name]
        assert [r.name for r in reads] == [read]
        assert {s.answer for s in kids + reads} == {root.id}


@pytest.mark.parametrize("route", ["loop", "kernel"])
def test_outputs_equal_with_recording_on_and_off(route, monkeypatch):
    if route == "kernel":
        _plain_route(monkeypatch)
    cfg = small_platform()
    eng = repro_torch.Engine(cfg, device="cpu")

    def answer():
        run = eng.run(_trace(n=150, seed=9))
        sweep = eng.sweep(_spec(cfg), _trace(n=150, seed=9))
        return (run.state, run.outs, run.summary(), sweep.states,
                sweep.outs, sweep.rows())
    off = answer()
    on, rec, _ = _recorded(answer)
    assert rec.spans
    _same(off, on)


def test_readouts_nesting_and_threads():
    """A readout with no engine root before it is an answer of its own;
    one opened inside a span is its child; a span another thread opens
    while this one records (that thread sees no profiler) neither joins
    nor ends this thread's recording; ``clear`` forgets the last root."""
    def other():
        with telemetry.span("emulator.pad_trace"):
            pass

    def work():
        with telemetry.span("counters.summary"):
            pass
        with telemetry.span("engine.run", tag=1) as root:
            root.set(more=2)
            with telemetry.span("counters.summary"):
                pass
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        with telemetry.span("counters.summary"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        work()
    lone, inner, root, after = telemetry.recorded().spans
    assert (lone.parent, lone.cause, lone.answer) == (None, None, lone.id)
    assert (inner.parent, inner.cause, inner.answer) == (root.id, None,
                                                         root.id)
    assert root.attrs == {"tag": 1, "more": 2}
    assert (after.parent, after.cause, after.answer) == (None, root.id,
                                                         root.id)
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("sweep.rows"):
            pass
    (again,) = telemetry.recorded().spans
    assert again.cause is None and again.answer == again.id


def test_a_new_recording_drops_the_last():
    """Spans opened while nothing records end a recording: the next
    recorded span starts a new one, as a profiler session follows
    another's answers made with no profiler."""
    def record(name):
        with profile(activities=[ProfilerActivity.CPU]):
            with telemetry.span(name):
                telemetry.count(name)

    record("engine.run")
    record("engine.sweep")          # back to back: one recording
    assert [s.name for s in telemetry.recorded().spans] == \
        ["engine.run", "engine.sweep"]
    with telemetry.span("emulator.pad_trace"):
        pass                        # nothing records
    assert len(telemetry.recorded().spans) == 2
    record("engine.sweep")
    rec = telemetry.recorded()
    assert [s.name for s in rec.spans] == ["engine.sweep"]
    assert rec.counters == {"engine.sweep": 1}


@pytest.mark.parametrize("points,resident,want", [
    (1, 15, 1), (15, 15, 1), (16, 15, 2), (30, 15, 2), (31, 15, 3),
    (16, 16, 1), (4, 1, 4), (64, 15, 5)])
def test_chunk_step_waves_arithmetic(points, resident, want):
    assert tcs.waves(points, resident) == want


def _anchors(host_ns):
    return [telemetry.Span(k + 1, None, k + 1, telemetry.LAUNCH_SPAN, h - 10,
                           h + 5, {"launch_ns": (h - 10, h)}, None)
            for k, h in enumerate(host_ns)]


def test_device_clock_fits_a_drifting_trace_past_a_late_anchor():
    """The trace's clock 2 ms behind the host's and 0.4% slow; one
    anchor's host time 2 ms late (the host held up after its enqueue) and
    one 15 us early: the late one is left out, the line holds the rest."""
    dev = [k * 50_000_000.0 for k in range(12)]
    host = [round(d / 0.996 + 2_000_000) for d in dev]
    host[5] += 2_000_000
    host[8] -= 15_000
    to_host = telemetry.device_clock(list(reversed(dev)), _anchors(host))
    for k, d in enumerate(dev):
        want = d / 0.996 + 2_000_000
        assert to_host(d) == pytest.approx(want, abs=5_000), k
    assert to_host(2.75e8) == pytest.approx(2.75e8 / 0.996 + 2e6, abs=5_000)


def test_device_clock_needs_one_anchor_a_launch():
    assert telemetry.device_clock([5.0], _anchors([25])) is not None
    assert telemetry.device_clock([5.0], _anchors([25]))(7.0) == 27.0
    two = telemetry.device_clock([0.0, 100.0], _anchors([10, 120]))
    assert two(50.0) == pytest.approx(65.0)
    assert telemetry.device_clock([], _anchors([])) is None
    assert telemetry.device_clock([1.0], _anchors([1, 2])) is None
    other = _anchors([1])[0]._replace(name="chunk_step.pack")
    assert telemetry.device_clock([1.0], [other]) is None


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel B has no CPU mode)")
    return torch.device("cuda", 0)


def _on_card(fn):
    """Run ``fn`` under a CUDA-only profiler, as the benchmark's traced
    run does; (the recording, the device operations (start ns, end ns,
    name) in start order)."""
    from torch.autograd import DeviceType
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted((e.start_ns(), e.end_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA)
    return telemetry.recorded(), ops


def _card_platform():
    return paper_platform().with_(chunk=512)


@pytest.mark.cuda
def test_device_operations_lie_inside_their_answers(card):
    eng = repro_torch.Engine(_card_platform(), device=card)
    traces = [_trace(n=65_536 + 100, seed=s, device=card, pages=40_000)
              for s in range(4)]
    eng.run(traces[0]).summary()
    torch.cuda.synchronize()
    rec, ops = _on_card(lambda: [eng.run(t).summary() for t in traces])
    to_host = telemetry.device_clock(
        [s for s, _, n in ops if "chunk_step" in n], rec.spans)
    assert to_host is not None
    tree = [(r.start_ns, max(s.end_ns for s in rec.spans
                             if s.answer == r.answer))
            for r in rec.spans if r.parent is None and r.cause is None]
    assert len(tree) == 4
    slack = 50_000
    held = [0] * len(tree)
    for s, e, name in ops:
        inside = [k for k, (lo, hi) in enumerate(tree)
                  if lo - slack <= to_host(s) and to_host(e) <= hi + slack]
        assert inside, (name, to_host(s), to_host(e), tree)
        held[inside[0]] += 1
    assert all(held)


@pytest.mark.cuda
def test_waves_and_stage_cycles_of_a_16_point_sweep(card):
    cfg = _card_platform()
    spec = SweepSpec(cfg, technologies=("3dxpoint", "stt-ram"),
                     fast_fractions=(1 / 9, 2 / 9),
                     policies=("hotness", "static"), link_lats=(600, 1200))
    eng = repro_torch.Engine(cfg, device=card)
    trace = _trace(n=16_384, device=card, pages=40_000)
    eng.sweep(spec, trace).rows()
    rec, _ = _on_card(lambda: eng.sweep(spec, trace).rows())
    (enq,) = [s for s in rec.spans if s.name == "chunk_step.enqueue"]
    a = enq.attrs
    resident = tcs.resident_clusters(str(card), cfg.chunk, cfg.n_banks,
                                     True)
    cluster = tcs.cluster_for(16, resident)
    assert (a["points"], a["cluster"], a["chunks"]) == (16, cluster, 32)
    assert a["resident"] == resident[cluster] > 0
    assert a["waves"] == min(tcs.waves(16, n) for n in resident.values()
                             if n) == -(-16 // resident[cluster])
    assert rec.counters == {"chunk_step.launches": 1,
                            "chunk_step.waves": a["waves"]}
    cycles = rec.buffers[("chunk_step.phases", str(card), 16)].sum(0).cpu()
    for phase in ("load", "stage345", "policy"):
        assert cycles[tcs.PHASES.index(phase)] > 0, phase


@pytest.mark.cuda
def test_stamped_launch_equals_the_release_launch(card):
    cfg = _card_platform()
    eng = repro_torch.Engine(cfg, device=card)
    trace = _trace(n=20_000, seed=5, device=card, pages=40_000)

    def answer():
        run = eng.run(trace)
        sweep = eng.sweep(_spec(cfg), trace)
        return (run.state, run.outs, run.summary(), sweep.states, sweep.outs,
                sweep.rows())
    off = answer()
    holder = []
    rec, _ = _on_card(lambda: holder.append(answer()))
    assert rec.buffers
    _same(off, holder[0])
