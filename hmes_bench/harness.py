"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, the metrics, and the result line.

The window is a closed loop with one client, as a researcher waits for
each answer before asking the next: it cycles through the cell's traces,
each answer from a fresh state, from the call into the program until the
answer's summary is on the host. Answers start until ``seconds`` have
passed and ``MIN_ANSWERS`` have ended; the window runs from the first
answer's start to the last one's end. With ``traced``, ``torch.profiler`` (CUPTI) records every device
operation of the window, on every card the cell runs on, and the
per-layer metrics are read from it.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time

import torch

from hmes_bench import devtrace, discover, hbm_bytes, judge, program
from hmes_bench import reference, tracegen, tracegen_large

# Top-level module names that no run may load: the JAX package, JAX and
# its libraries. Compared whole, since ``repro_torch`` starts with
# ``repro``.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
# A window holds at least this many answers, whatever its length: the
# 95th percentile reads two or more.
MIN_ANSWERS = 2
PEAKS = json.loads((pathlib.Path(__file__).parent / "peaks.json").read_text())


@dataclasses.dataclass
class Context:
    """What a metric's reader reads (``metrics/<name>.py``)."""
    setup_s: float
    window_s: float
    answers_ms: list          # each answer's time, host clock
    requests: int             # emulated requests (a point each) completed
    chunks: int               # trace chunks the window's answers ran
    peaks: dict
    bytes: int | None = None  # bytes the window's answers had to move
    ops: list | None = None   # the window's device operations (traced)
    busy_s: float | None = None  # each card's busy time, their mean
    chips: int = 1            # the cards the cell runs on


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def card_line() -> str:
    """Each card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"
    return "; ".join(out.stdout.strip().splitlines()) \
        if out.stdout.strip() else "nvidia-smi gave nothing"


def _sync(devices: list) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


# The keys a configuration's ``trace`` recipe may hold: the recipe
# table's fields (``tracegen.Workload``), with ``source`` for its name.
RECIPE_KEYS = frozenset({f.name for f in dataclasses.fields(
    tracegen.Workload)} - {"name"} | {"source"})
RECIPE_NEEDS = frozenset({"source", "footprint_bytes", "total_traffic_bytes",
                          "write_frac", "pattern"})


def trace_spec(config: dict, seed: int) -> tracegen.TraceSpec:
    """The trace recipe of a configuration at seed ``seed``, in its
    platform's page size: ``config["trace"]`` names a row of the frozen
    table (``{"workload": name, "scale": s}``) or states one
    (``{"recipe": {...}, "scale": s}``, the table's fields and a
    ``source`` naming the workload it stands for)."""
    spec = config["trace"]
    page_size = config["platform"]["page_size"]
    if ("workload" in spec) == ("recipe" in spec):
        raise ValueError("a configuration's trace names a table workload "
                         "(\"workload\") or states a recipe (\"recipe\"), "
                         f"exactly one of them; got {sorted(spec)}")
    if "workload" in spec:
        return tracegen.workload_spec(spec["workload"], scale=spec["scale"],
                                      page_size=page_size, seed=seed)
    r = spec["recipe"]
    if not RECIPE_NEEDS <= set(r) <= RECIPE_KEYS:
        raise ValueError(f"a trace recipe needs {sorted(RECIPE_NEEDS)} and "
                         f"may add {sorted(RECIPE_KEYS - RECIPE_NEEDS)}; got "
                         f"{sorted(r)}")
    if r["pattern"] not in tracegen._PATTERNS:
        raise ValueError(f"trace pattern {r['pattern']!r} is none of "
                         f"{sorted(tracegen._PATTERNS)}")
    w = tracegen.Workload(name=r["source"], **{
        k: v for k, v in r.items() if k != "source"})
    return tracegen.recipe_spec(w, scale=spec["scale"], page_size=page_size,
                                seed=seed)


def make_traces(config: dict, traffic: dict, seed: int,
                count: int | None = None) -> list:
    """The cell's traces on the CPU (the first ``count`` of them): trace
    ``i`` of ``traffic["traces"]`` drawn from seed ``traces * seed + i``."""
    k = traffic["traces"]
    out = []
    for i in range(k if count is None else count):
        t = tracegen_large.generate(trace_spec(config, k * seed + i))
        if len(t.page) != config["requests"]:
            raise ValueError(f"trace {i} has {len(t.page)} requests, the "
                             f"configuration says {config['requests']}")
        out.append(t)
    return out


def load_cell(root: pathlib.Path, workload: str, device: torch.device):
    """(BENCHMARK.json, the cell's configuration, its traffic, the
    session its entry point prepared on ``device`` for the cell's
    ``chips`` cards)."""
    bench = discover.load_benchmark(root)
    cell = discover.cell(bench, workload)
    config = discover.config(root, bench, cell["config"])
    traffic = discover.traffic(root, cell["traffic"])
    session = discover.entry(root, traffic["entry"]).prepare(
        config, traffic, device, cell["chips"])
    return bench, config, traffic, session


def run_cell(root: pathlib.Path, workload: str, seed: int, seconds: float,
             traced: bool, device: torch.device, t0: float,
             log=lambda s: print(s, file=sys.stderr, flush=True)) -> dict:
    """Run cell ``workload`` once; returns the result line's object.
    ``t0`` is the process's start on the host clock."""
    marks = [("imports", time.perf_counter())]
    bench, config, traffic, session = load_cell(root, workload, device)
    chips = discover.cell(bench, workload)["chips"]
    cards = [torch.device("cuda", i) for i in range(chips)] \
        if device.type == "cuda" else [device]
    metrics = discover.cell_metrics(bench, workload, traced)
    readers = {m["name"]: discover.reader(root, m["name"]) for m in metrics}
    marks.append(("engine", time.perf_counter()))
    traces = make_traces(config, traffic, seed)
    n = config["requests"]
    chunk = config["platform"]["chunk"]
    on_dev = [program.trace_on(t, device) for t in traces]
    marks.append(("traces", time.perf_counter()))
    answer_bytes = []
    for t in on_dev:                       # warm up every trace's shapes
        res, _ = session.answer(t)
        _sync(cards)
        if traced:
            answer_bytes.append(hbm_bytes.answer_bytes(
                t.page, t.is_write, session.device_out(res, n), chunk=chunk,
                points=session.point_geometry()))
        del res
    _sync(cards)
    # What set-up made lives through the window: the collector need not
    # scan it again in every full collection the answers trigger.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    marks.append(("warm-up", time.perf_counter()))
    split = ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b) in
                      zip([("", t0)] + marks, marks))
    log(f"set-up {setup_s:.3f} s ({split} s): {len(traces)} traces of {n} "
        f"requests, {session.points} design point(s)")

    prof = None
    if traced and device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
        prof.start()
    spans, failed, last = [], 0, None
    w0 = time.perf_counter()
    while len(spans) < MIN_ANSWERS or time.perf_counter() - w0 < seconds:
        k = len(spans) % len(on_dev)
        start = time.perf_counter()
        try:
            res, readout = session.answer(on_dev[k])
            _sync(cards)
        except RuntimeError as e:
            failed += 1
            log(f"answer {len(spans)} failed: {e}")
            spans.append((start, time.perf_counter(), k))
            break
        spans.append((start, time.perf_counter(), k))
        last = (res, readout, k)
    if prof is not None:
        prof.stop()
    window_s = spans[-1][1] - spans[0][0]
    peak = max(torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0
               for d in cards)

    # The comparison, once the window has closed and the peak is read:
    # the last answer to the host, the program's state freed, then the
    # reference on the same trace.
    numbers = dict.fromkeys(judge.LIMITS, None)
    compared = last is not None
    if compared:
        res, readout, k = last
        got = session.record(res, readout, n)
        del res, last
        if device.type == "cuda":
            torch.cuda.empty_cache()
        r0 = time.perf_counter()
        want = reference.answer(config, session.grid, traces[k], device)
        log(f"reference {time.perf_counter() - r0:.3f} s on trace {k}")
        numbers = judge.compare(got, want)
    correct = failed == 0 and compared and judge.verdict(numbers)

    ops = None if prof is None else devtrace.device_ops(prof)
    ctx = Context(
        setup_s=setup_s, window_s=window_s,
        answers_ms=[(e - s) * 1e3 for s, e, _ in spans],
        requests=(len(spans) - failed) * n * session.points,
        chunks=(len(spans) - failed) * -(-n // chunk), peaks=PEAKS,
        bytes=sum(answer_bytes[k] for _, _, k in spans) if traced else None,
        ops=ops, chips=chips,
        busy_s=None if ops is None else devtrace.mean_busy_s(ops, chips))
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else device.type,
           "count": len(cards), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(spans), "failed": failed,
              "metrics": values, "device": dev}
    if traced:
        dev["busy_s"] = ctx.busy_s
        dev["window_s"] = window_s
        if ops is not None:
            result["breakdown"] = devtrace.breakdown(ops, chips)
    if device.type == "cuda":
        result["card"] = card_line()
    result["checks"] = {k: {"value": v, "limit": judge.LIMITS[k]}
                        for k, v in numbers.items()}
    for k, v in result["metrics"].items():
        log(f"metric {k} {v['value']} {v['unit']}")
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    return result
