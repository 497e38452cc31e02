"""The per-layer readers of the device trace on one card and on several:
on a cell of one card each gives exactly what the one-card formulas give
(the operation lists the harness recorded on the card, and a made-up
one); on four cards each gives the per-card value it states, worked out
by hand on a made-up list and by the plain formulas on a recorded one."""
import json
import pathlib

import pytest

from hmes_bench import devtrace, discover, harness, spans
from repro_torch import telemetry

ROOT = pathlib.Path(__file__).resolve().parents[2]
DATA = pathlib.Path(__file__).resolve().parent / "data"
RECORDED = sorted(DATA.glob("ops_*.json"))
ONE_CARD = [p for p in RECORDED if json.loads(p.read_text())["chips"] == 1]
TRACE_READERS = ("session_host_ms", "kernels_per_answer",
                 "chunk_step_us_per_chunk", "chunk_step_roofline",
                 "device_idle_share", "mfu_hbm")
PHASES = ("load", "rx", "redirect", "stage345", "commit", "satw", "decay",
          "retire", "policy")
K = "chunk_step_kernel<false, true>"


def read(name, ctx):
    return discover.reader(ROOT, name).read(ctx)


def context(ops, chips, window_s, answers_ms, chunks, bytes, peaks):
    """The reader context as the harness builds it."""
    return harness.Context(
        setup_s=1.0, window_s=window_s, answers_ms=answers_ms, requests=1,
        chunks=chunks, peaks=peaks, bytes=bytes, ops=ops, chips=chips,
        busy_s=devtrace.mean_busy_s(ops, chips))


def one_card(ctx) -> dict:
    """Each reader's value by the one-card formulas the benchmark had
    before it knew of cards (the device's busy time the union of every
    operation)."""
    busy = devtrace.busy_s(ctx.ops)
    cs = sum(o.end_us - o.start_us for o in ctx.ops if "chunk_step" in o.name)
    peak = ctx.peaks["hbm_bytes_per_s"]
    return {
        "session_host_ms": (ctx.window_s - busy) / len(ctx.answers_ms) * 1e3,
        "kernels_per_answer": len(ctx.ops) / len(ctx.answers_ms),
        "chunk_step_us_per_chunk": cs / ctx.chunks,
        "chunk_step_roofline": 100.0 * ctx.bytes / peak / busy,
        "device_idle_share": 100.0 * (1.0 - busy / ctx.window_s),
        "mfu_hbm": 100.0 * ctx.bytes / peak / (sum(ctx.answers_ms) / 1e3)}


def one_card_breakdown(ops, top=10) -> dict:
    """The breakdown as the one-card benchmark named it."""
    by_op, gaps = {}, {}
    for o in ops:
        n = devtrace._short(o.name)
        by_op[n] = by_op.get(n, 0.0) + (o.end_us - o.start_us) / 1e6
    busy = devtrace.busy_intervals(ops)
    for (_, end, _, last), (start, _, first, _) in zip(busy, busy[1:]):
        n = f"after {devtrace._short(last)} before {devtrace._short(first)}"
        gaps[n] = gaps.get(n, 0.0) + (start - end) / 1e6
    rank = lambda d: [[k, v] for k, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}


def recorded(path):
    d = json.loads(path.read_text())
    ops = [devtrace.DeviceOp(d["names"][i], s, e, c) for i, s, e, c in d["ops"]]
    ctx = context(ops, d["chips"], d["window_s"], d["answers_ms"],
                  d["chunks"], d["bytes"],
                  json.loads((ROOT / "hmes_bench" / "peaks.json").read_text()))
    return d, ctx


@pytest.fixture
def recording(monkeypatch):
    """Make the program's recording the one a test gives."""
    def give(counters=None, buffers=None):
        rec = telemetry.Recording(
            (telemetry.Span(1, None, 1, "engine.sweep", 0, 1, {}, None),),
            counters or {}, buffers or {})
        monkeypatch.setattr(telemetry, "recorded", lambda: rec)
    return give


def test_recorded_lists_are_there():
    cells = {json.loads(p.read_text())["cell"] for p in RECORDED}
    bench = discover.load_benchmark(ROOT)
    assert cells == {w["name"] for w in bench["workloads"]}


@pytest.mark.parametrize("path", ONE_CARD, ids=lambda p: p.stem)
def test_one_card_readings_are_unchanged(path):
    d, ctx = recorded(path)
    assert ctx.busy_s == devtrace.busy_s(ctx.ops)
    want = one_card(ctx)
    for name in TRACE_READERS:
        assert read(name, ctx) == want[name], name
    assert devtrace.breakdown(ctx.ops, 1) == one_card_breakdown(ctx.ops)
    assert devtrace.breakdown(ctx.ops) == one_card_breakdown(ctx.ops)


@pytest.mark.parametrize("path", RECORDED, ids=lambda p: p.stem)
def test_recorded_readings_by_card(path, recording):
    """Every cell's recorded list: each reader against its formula per
    card, every share of a peak or roofline at most 100%, and the stage
    split, from the stage cycles recorded a card, summing to
    ``chunk_step_us_per_chunk``."""
    d, ctx = recorded(path)
    chips, ops = d["chips"], ctx.ops
    cards = [[o for o in ops if o.device == c] for c in range(chips)]
    assert sum(map(len, cards)) == len(ops) and all(cards)
    busy = [devtrace.busy_s(c) for c in cards]
    cs = [sum(o.end_us - o.start_us for o in c if "chunk_step" in o.name)
          for c in cards]
    peak = chips * ctx.peaks["hbm_bytes_per_s"]
    want = {
        "device_idle_share": sum(100 * (1 - b / ctx.window_s)
                                 for b in busy) / chips,
        "chunk_step_us_per_chunk": max(cs) / ctx.chunks,
        "chunk_step_roofline": 100 * ctx.bytes / peak / (sum(busy) / chips),
        "mfu_hbm": 100 * ctx.bytes / peak / (sum(ctx.answers_ms) / 1e3),
        "kernels_per_answer": len(ops) / len(ctx.answers_ms),
        "session_host_ms": (ctx.window_s - devtrace.busy_s(ops))
        / len(ctx.answers_ms) * 1e3}
    for name, v in want.items():
        assert read(name, ctx) == pytest.approx(v, rel=1e-12), name
    for name in ("device_idle_share", "chunk_step_roofline", "mfu_hbm"):
        assert 0 < read(name, ctx) <= 100, name
    import torch
    recording(counters=d["counters"], buffers={
        ("chunk_step.phases", dev, 1): torch.tensor([c])
        for dev, c in d["phases"].items()})
    split = sum(read(f"chunk_step_phase_us.{p}", ctx) for p in PHASES)
    assert split == pytest.approx(read("chunk_step_us_per_chunk", ctx),
                                  rel=1e-9)
    assert read("chunk_step_waves", ctx) == \
        d["counters"]["chunk_step.waves"] / d["counters"]["chunk_step.launches"]


# Four cards by hand (us): card 0 a copy 0-1,000, kernel B 1,000-5,000 and a
# copy 8,000-8,500 (busy 5.5 ms); card 1 kernel B 1,200-6,200 (5.0 ms); card
# 2 kernel B 1,300-4,300 then a copy to 4,800 (3.5 ms); card 3 kernel B
# 1,400-7,400 (6.0 ms). Their union: 0-7,400 and 8,000-8,500 (7.9 ms).
FOUR = [devtrace.DeviceOp("copy", 0.0, 1000.0, 0),
        devtrace.DeviceOp(K, 1000.0, 5000.0, 0),
        devtrace.DeviceOp(K, 1200.0, 6200.0, 1),
        devtrace.DeviceOp(K, 1300.0, 4300.0, 2),
        devtrace.DeviceOp(K, 1400.0, 7400.0, 3),
        devtrace.DeviceOp("copy", 4300.0, 4800.0, 2),
        devtrace.DeviceOp("copy", 8000.0, 8500.0, 0)]


def four_cards():
    return context(FOUR, 4, 0.010, [4.0, 6.0], 100, 4e9,
                   {"hbm_bytes_per_s": 1e12})


def test_four_cards_by_hand():
    ctx = four_cards()
    assert ctx.busy_s == pytest.approx(0.005)          # (5.5+5+3.5+6)/4 ms
    expect = {
        "device_idle_share": 50.0,         # mean of 45, 50, 65, 40 %
        "chunk_step_us_per_chunk": 60.0,   # card 3: 6,000 us / 100 chunks
        "chunk_step_roofline": 20.0,       # 4e9 B / 4e12 B/s / 5 ms
        "mfu_hbm": 10.0,                   # 4e9 B / 4e12 B/s / 10 ms
        "kernels_per_answer": 3.5,         # 7 operations, 2 answers
        "session_host_ms": 1.05}           # (10 - 7.9) ms / 2 answers
    for name, v in expect.items():
        assert read(name, ctx) == pytest.approx(v, rel=1e-12), name
    b = devtrace.breakdown(FOUR, 4)
    assert b["idle_gaps"] == [[f"cuda:0 after {K} before copy",
                               pytest.approx(0.003)]]
    assert b["device_ops"][0] == [K, pytest.approx(0.018)]


def test_four_cards_stage_split_is_the_slowest_cards(recording):
    import torch
    ctx = four_cards()
    slow = torch.tensor([[1, 0, 0, 6, 1, 0, 1, 0, 1]], dtype=torch.int64)
    other = torch.tensor([[9, 9, 9, 9, 9, 9, 9, 9, 9]], dtype=torch.int64)
    bufs = {("chunk_step.phases", f"cuda:{c}", 16): other for c in range(3)}
    recording(buffers={**bufs, ("chunk_step.phases", "cuda:3", 16): slow})
    got = {p: read(f"chunk_step_phase_us.{p}", ctx) for p in PHASES}
    assert got["stage345"] == pytest.approx(6 / 10 * 60.0)
    assert got["rx"] == 0
    assert sum(got.values()) == pytest.approx(60.0)
    # The slowest card's cycles missing: no number of another card's.
    recording(buffers=bufs)
    assert all(read(f"chunk_step_phase_us.{p}", ctx) is None for p in PHASES)


def test_one_card_made_up_list_is_unchanged(recording):
    import torch
    ops = [devtrace.DeviceOp("copy", 0.0, 100.0),
           devtrace.DeviceOp(K, 150.0, 900.0),
           devtrace.DeviceOp("copy", 880.0, 990.0),
           devtrace.DeviceOp(K, 1500.0, 2100.0)]
    ctx = context(ops, 1, 0.0025, [1.1, 1.3], 7, 123456789,
                  {"hbm_bytes_per_s": 3.35e12})
    want = one_card(ctx)
    for name in TRACE_READERS:
        assert read(name, ctx) == want[name], name
    assert devtrace.breakdown(ops, 1) == one_card_breakdown(ops)
    cycles = torch.tensor([[9, 1, 2, 20, 3, 1, 5, 6, 8]], dtype=torch.int64)
    recording(buffers={("chunk_step.phases", "cuda:0", 1): cycles,
                       ("chunk_step.phases", "cuda:0", 2): cycles * 2})
    total = 3 * 55
    cs = 750.0 + 600.0
    for k, p in enumerate(PHASES):
        assert read(f"chunk_step_phase_us.{p}", ctx) == \
            3 * int(cycles[0, k]) / total * cs / 7
    assert spans.phase_us(ctx, "load") is not None
