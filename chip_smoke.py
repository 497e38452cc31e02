#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the emulator on one CUDA card.

Run from the root of a checkout, with one CUDA device visible:

    python3 chip_smoke.py

Phases, each printing its lines in order:

1. **Device** — the card's name and power limit (``nvidia-smi``).
2. **Build** — ``nvcc`` compiles both hand-written kernels from
   ``src/repro_torch/kernels/csrc`` for ``sm_90a`` into
   ``build/repro_torch/`` (one process per source, started together).
3. **Kernel A** (``hmmu_lookup``) against its plain version at the
   paper's geometry (294,912 x 8 table), B in {1, 4}, m in {512, 514},
   with negative and past-the-end pages: ``torch.equal``; its time, the
   plain version's, and one advanced-indexing call's (``library_ms``).
4. **Kernel B** (``chunk_step``) against its plain version
   (``step_ref(seq=True)``) after every chunk: each of the six policies,
   on ``small_platform`` and on the paper geometry, from an adversarial
   state (pins, a poisoned page, a swap in flight) with an endurance
   budget and a fault plan of deaths and transients, over more than
   2 x ``decay_every`` chunks; once with B = 2 design points (different
   params) in one launch.
5. **The main path at full size** — ``Engine(paper_platform().with_(
   chunk=512, policy="hotness", hot_threshold=4)).run`` on the port's
   ``520.omnetpp`` trace at scale 1e-4 (1,342,177 requests, 2,622
   chunks), once through kernel B (``chunk_step_kernel="auto"``) and once
   through the scan path whose stage-2 gather is kernel A (``"off"``);
   each route's launch count must equal the number of chunks, and the two
   final states and outputs must be bitwise equal.
6. One JSON line of per-kernel numbers, the card line again, and the last
   line ``{"ok": true, "device": {...}}``.

Any mismatch or error exits nonzero. Without a CUDA device, or without
the rest of the repository, it exits nonzero before printing a result.
Only the port is imported: nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory, NVIDIA's data sheet
POLICIES = ("static", "hotness", "write_bias", "stream", "hotness_global",
            "wear_level")


class Mismatch(AssertionError):
    pass


def cuda_device(torch):
    return torch.device("cuda", 0)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def wall_ms(torch, fn, iters: int) -> float:
    """Host-clock milliseconds per call of ``fn``, synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms(torch, fn, iters: int, name: str | None = None) -> float:
    """Device milliseconds per call of ``fn`` from a CUPTI trace
    (``torch.profiler``): the kernels whose name contains ``name``, or
    every kernel when ``name`` is None. Falls back to CUDA events around
    the calls when the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t and (name is None or name in ev.key):
            total_us += t
    if total_us > 0:
        return total_us / 1e3 / iters
    print(f"  (no device time in the trace for {name or 'the call'}: "
          "timing with CUDA events)")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_diff(torch, a, b) -> int:
    if a.dtype == torch.bool:
        a, b = a.to(torch.int32), b.to(torch.int32)
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0


# --------------------------------------------------------------- phase 3
def check_lookup(torch, dev, hl) -> dict:
    n_pages = 294_912
    g = torch.Generator().manual_seed(0)
    err = 0
    timing = {}
    for b in (1, 4):
        table = torch.randint(-2 ** 20, 2 ** 20, (b, n_pages, 8), generator=g,
                              dtype=torch.int32).to(dev)
        for m in (512, 514):
            pages = torch.randint(0, n_pages, (b, m), generator=g,
                                  dtype=torch.int32)
            pages[:, :4] = torch.tensor([-1, -n_pages - 3, n_pages, 2 ** 30],
                                        dtype=torch.int32)
            pages = pages.to(dev)
            got = hl.hmmu_lookup_cuda(table, pages)
            want = hl.hmmu_lookup_plain(table, pages)
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            err = max(err, max_abs_diff(torch, got, want))
            print(f"  kernel A  B={b} m={m}: torch.equal={ok}")
            if not ok:
                raise Mismatch(f"hmmu_lookup differs at B={b} m={m}")
            b_idx = torch.arange(b, device=dev)[:, None].expand(b, m)
            idx = pages.to(torch.int64).clamp(0, n_pages - 1)
            k_ms = device_ms(torch, lambda: hl.hmmu_lookup_cuda(table, pages),
                             200, "hmmu_lookup_kernel")
            p_ms = wall_ms(torch, lambda: hl.hmmu_lookup_plain(table, pages),
                           200)
            lib_ms = device_ms(torch, lambda: table[b_idx, idx], 200)
            byts = b * m * (32 + 32 + 4)
            print(f"    kernel {k_ms * 1e3:.2f} us (device), plain "
                  f"{p_ms * 1e3:.2f} us (wall), advanced indexing "
                  f"{lib_ms * 1e3:.2f} us (device), bound "
                  f"{byts / HBM_BYTES_PER_S * 1e9:.2f} ns ({byts} B)")
            timing[(b, m)] = (k_ms, p_ms, lib_ms,
                              byts / HBM_BYTES_PER_S * 1e3)
    return {"max_abs_err": err, "timing": timing}


# --------------------------------------------------------------- phase 4
def adversarial_setup(torch, dev, rt, cfg, n_chunks, seed):
    """Pins, a poisoned page, a swap in flight; a trace hammering a few
    slow pages and the swap pair; a plan of deaths and transients."""
    import numpy as np
    from repro_torch.core import table as tl
    params = cfg.runtime(dev)
    st = rt.core.init_state(cfg, params)
    nf = cfg.n_fast_pages
    tab = tl.set_flags(st.table, [0, 1], tl.PIN_FAST)
    tab = tl.set_flags(tab, [nf + 1], tl.PIN_SLOW)
    tab = tl.set_flags(tab, [nf + 3], tl.POISONED)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    st = st._replace(table=tab, dma=st.dma._replace(
        active=i32(1), page_a=i32(nf + 2), page_b=i32(nf - 1), start=i32(0)))
    rng = np.random.default_rng(seed)
    n = n_chunks * cfg.chunk
    page = np.where(rng.random(n) < 0.5, nf + rng.integers(0, 8, n),
                    rng.integers(0, cfg.n_pages, n)).astype(np.int32)
    page[rng.random(n) < 0.15] = nf + 2
    page[rng.random(n) < 0.1] = nf - 1
    off = (rng.integers(0, cfg.page_size // 64, n) * 64).astype(np.int32)
    trace = rt.core.Trace(*(torch.as_tensor(x, device=dev) for x in (
        page, off, rng.random(n) < 0.5, np.full(n, 64, np.int32))))
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[-5:] = False
    plan = rt.core.seeded_plan(seed, pages=np.arange(nf, nf + 12),
                               n_chunks=n_chunks, n_deaths=2, n_transient=8,
                               device=dev)
    return params, st, trace, valid, plan


def scalars_of(cs, st):
    return cs.StepScalars(
        clock=st.clock, clock_ptr=st.clock_ptr, chunk_idx=st.chunk_idx,
        dma=st.dma, link_free_rx=st.link_free_rx,
        link_free_tx=st.link_free_tx, last_return=st.last_return,
        rescue_page=st.rescue_page, min_wear=st.min_wear,
        fault_cursor=st.fault_cursor)


def compare_step(torch, where, got, want) -> int:
    """Compare (table, scalars, bank_free, outs) of the kernel and the
    plain version exactly; returns the max abs difference (0)."""
    kt, ksc, kbf, ko = got
    pt, psc, pbf, po = want
    err = 0
    pairs = [("table", kt, pt), ("bank_free", kbf, pbf)]
    for f in ("clock", "clock_ptr", "chunk_idx", "link_free_rx",
              "link_free_tx", "last_return", "rescue_page", "min_wear",
              "fault_cursor"):
        pairs.append((f, getattr(ksc, f), getattr(psc, f)))
    for f in ("active", "page_a", "page_b", "start", "swaps_done"):
        pairs.append(("dma." + f, getattr(ksc.dma, f), getattr(psc.dma, f)))
    for k in po:
        pairs.append(("outs." + k, ko[k], po[k]))
    for name, a, b in pairs:
        a = a.to(torch.int32) if a.dtype == torch.bool else a
        b = b.to(torch.int32) if b.dtype == torch.bool else b
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise Mismatch(f"chunk_step differs from its plain version at "
                           f"{where}: {name}")
        err = max(err, max_abs_diff(torch, a, b))
    return err


def check_chunk_step(torch, dev, rt, cs) -> dict:
    from repro_torch.core.policies import PolicyRegistry
    reg = PolicyRegistry.snapshot()
    err = 0
    times = {}
    geometries = (
        ("small", rt.core.small_platform(chunk=16)),
        ("paper", rt.core.paper_platform().with_(chunk=512)))
    for geom, base in geometries:
        for policy in POLICIES:
            cfg = base.with_(policy=policy, hot_threshold=2, decay_every=4,
                             endurance_budget=6, write_weight=3)
            n_chunks = 2 * cfg.decay_every + 3
            params, st, trace, valid, plan = adversarial_setup(
                torch, dev, rt, cfg, n_chunks, seed=len(policy))
            on = cfg.with_(chunk_step_kernel="on")
            k = (st.table.clone(), scalars_of(cs, st), st.bank_free.clone())
            p = (st.table.clone(), scalars_of(cs, st), st.bank_free.clone())
            retired = injected = 0
            k_s = p_s = 0.0
            for c in range(n_chunks):
                sl = slice(c * cfg.chunk, (c + 1) * cfg.chunk)
                args = [x[sl] for x in trace] + [valid[sl]]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                kt, ksc, kbf, ko = cs.chunk_step(on, reg, *k[:1], params,
                                                 k[1], k[2], *args, plan)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                pt, psc, pbf, po = cs.step_ref(cfg, reg, p[0], params, p[1],
                                               p[2], *args, plan, seq=True)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                k_s += t1 - t0
                p_s += t2 - t1
                err = max(err, compare_step(
                    torch, f"{geom}/{policy} chunk {c}",
                    (kt, ksc, kbf, ko), (pt, psc, pbf, po)))
                k, p = (kt, ksc, kbf), (pt, psc, pbf)
                retired += int(po["retired"]) >= 0
                injected += int(po["injected"].sum())
            print(f"  kernel B  {geom:5s} {policy:14s} {n_chunks} chunks "
                  f"equal; swaps {int(k[1].dma.swaps_done)}, retirements "
                  f"{retired}, injected {injected}; per chunk kernel "
                  f"{k_s / n_chunks * 1e3:.3f} ms, plain "
                  f"{p_s / n_chunks * 1e3:.3f} ms (wall)")
            if retired == 0 or injected == 0:
                raise Mismatch(f"{geom}/{policy}: the fault paths never fired")
            times[(geom, policy)] = (k_s / n_chunks, p_s / n_chunks)
    err = max(err, check_batched(torch, dev, rt, cs, reg))
    return {"max_abs_err": err, "times": times}


def check_batched(torch, dev, rt, cs, reg) -> int:
    """B = 2 design points with different params in ONE launch, each
    held against its own plain run."""
    base = rt.core.paper_platform().with_(chunk=512, decay_every=4,
                                          endurance_budget=6)
    cfgs = [base.with_(policy="hotness", hot_threshold=2),
            base.with_(policy="wear_level", hot_threshold=3, wear_slack=8,
                       issue_gap=6)]
    n_chunks = 10
    setups = [adversarial_setup(torch, dev, rt, c, n_chunks, seed=11)
              for c in cfgs]
    _, st0, trace, valid, plan = setups[0]
    plains = [(s[1].table.clone(), scalars_of(cs, s[1]),
               s[1].bank_free.clone()) for s in setups]
    table = torch.stack([s[1].table for s in setups]).contiguous()
    scs = [scalars_of(cs, s[1]) for s in setups]
    bank = torch.stack([s[1].bank_free for s in setups]).contiguous()
    err = 0
    for c in range(n_chunks):
        sl = slice(c * base.chunk, (c + 1) * base.chunk)
        args = [x[sl] for x in trace] + [valid[sl]]
        packed = [cs._pack_scalars(s[0], sc) for s, sc in zip(setups, scs)]
        ints = torch.stack([p[0] for p in packed])
        floats = torch.stack([p[1] for p in packed])

        def two(x):
            return torch.stack([x.to(torch.int32)] * 2).contiguous()
        scv, bank, ret, devo, lat, poi, inj = cs.chunk_step_cuda(
            base, reg, table, ints, floats, bank, *(two(a) for a in args),
            two(plan.transient), two(plan.deaths))
        for b, (setup, cfg) in enumerate(zip(setups, cfgs)):
            pt, psc, pbf, po = cs.step_ref(cfg, reg, plains[b][0], setup[0],
                                           plains[b][1], plains[b][2], *args,
                                           plan, seq=True)
            plains[b] = (pt, psc, pbf)
            sc, held, retired, tomb = cs._unpack_out_scalars(scv[b])
            outs = {"returns": ret[b], "device": devo[b], "latency": lat[b],
                    "held": held, "poisoned": poi[b] != 0,
                    "injected": inj[b] != 0, "retired": retired,
                    "tombstone": tomb}
            err = max(err, compare_step(torch, f"B=2 point {b} chunk {c}",
                                        (table[b], sc, bank[b], outs),
                                        (pt, psc, pbf, po)))
        scs = [cs._unpack_out_scalars(scv[b])[0] for b in range(2)]
    print(f"  kernel B  B=2 (hotness, wear_level; different params) "
          f"{n_chunks} chunks in one launch each: equal")
    return err


# --------------------------------------------------------------- phase 5
def run_main_path(torch, dev, rt, hl, cs) -> dict:
    from repro_torch.trace import workload_trace
    cfg = rt.paper_platform().with_(chunk=512, policy="hotness",
                                    hot_threshold=4)
    trace, _, n = workload_trace("520.omnetpp", scale=1e-4, device=dev)
    n_chunks = -(-n // cfg.chunk)
    print(f"  trace 520.omnetpp scale 1e-4: {n} requests, footprint "
          f"{int(trace.page.max()) + 1} pages, {n_chunks} chunks")
    results = {}
    for route, kernel in (("auto", cs.KERNEL), ("off", hl.KERNEL)):
        eng = rt.Engine(cfg.with_(chunk_step_kernel=route))
        torch.cuda.synchronize()
        hl.KERNEL.launches = 0
        cs.KERNEL.launches = 0
        t0 = time.perf_counter()
        res = eng.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"hmmu_lookup": hl.KERNEL.launches,
                  "chunk_step": cs.KERNEL.launches}
        summary = res.summary()
        print(f"  route {route!r}: launches {counts}; wall {wall:.3f} s, "
              f"{wall / n * 1e6:.4f} us/request; swaps "
              f"{int(res.state.dma.swaps_done)}")
        print(f"    counters {json.dumps(summary)}")
        if kernel.launches != n_chunks:
            raise Mismatch(f"route {route}: {kernel.name} launched "
                           f"{kernel.launches} times, not {n_chunks}")
        results[route] = (res, counts, wall)
    a, b = results["auto"][0], results["off"][0]
    for k in a.outs:
        if not torch.equal(a.outs[k], b.outs[k]):
            raise Mismatch(f"main path: outs[{k}] differs between routes")
    check_same_state(torch, a.state, b.state)
    check_outputs(torch, rt, cfg, a, n)
    print("  both routes: final states, counters and outputs bitwise equal")
    return {"cfg": cfg, "trace": trace, "n": n, "n_chunks": n_chunks,
            "results": results}


def check_same_state(torch, s, t, path="state"):
    if isinstance(s, tuple):
        for f in s._fields:
            check_same_state(torch, getattr(s, f), getattr(t, f),
                             f"{path}.{f}")
        return
    if s.dtype != t.dtype or not torch.equal(s, t):
        raise Mismatch(f"main path: {path} differs between routes")


def check_outputs(torch, rt, cfg, res, n):
    """The repo's own means: shapes, ranges, counter totals, and the
    packed-table invariants."""
    o = res.outs
    for k in ("returns", "device", "latency"):
        if o[k].shape != (n,):
            raise Mismatch(f"outs[{k}] has shape {tuple(o[k].shape)}")
    if not bool(((o["device"] == 0) | (o["device"] == 1)).all()):
        raise Mismatch("a request reached no device")
    if not bool((o["latency"] > 0).all()):
        raise Mismatch("a request has no positive latency")
    c = res.state.counters
    total = int(c.reads_fast + c.writes_fast + c.reads_slow + c.writes_slow)
    if total != n:
        raise Mismatch(f"counters count {total} requests, not {n}")
    for f in ("bytes_read_fast", "sum_read_latency", "energy_pj"):
        if not bool(torch.isfinite(getattr(c, f))):
            raise Mismatch(f"counter {f} is not finite")
    rt.core.check_table(cfg, res.state.table)


def kernel_b_numbers(torch, dev, rt, cs, main, n_chunks=256) -> dict:
    """Kernel B's device time per launch, its plain version's wall time
    per chunk, and its byte bound, on the first chunks of the main
    trace."""
    cfg, trace = main["cfg"], main["trace"]
    n_chunks = min(n_chunks, len(trace) // cfg.chunk)
    sub = rt.core.Trace(*(x[:n_chunks * cfg.chunk] for x in trace))
    eng = rt.Engine(cfg.with_(chunk_step_kernel="on"))
    k_ms = device_ms(torch, lambda: eng.run(sub), 1, "chunk_step_kernel") \
        / n_chunks
    from repro_torch.core.policies import PolicyRegistry
    reg = PolicyRegistry.snapshot()
    params = eng.params
    st = eng.init_state()
    p = (st.table, scalars_of(cs, st), st.bank_free)
    valid = torch.ones(cfg.chunk, dtype=torch.bool, device=dev)
    n_plain = min(16, n_chunks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(n_plain):
        sl = slice(c * cfg.chunk, (c + 1) * cfg.chunk)
        size = sub.size[sl]
        pt, psc, pbf, _ = cs.step_ref(cfg, reg, p[0], params, p[1], p[2],
                                      sub.page[sl], sub.offset[sl],
                                      sub.is_write[sl], size, valid,
                                      seq=True)
        p = (pt, psc, pbf)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3 / n_plain
    # Bytes the step must move on these chunks: the request vectors in
    # (5 x 4 B) and out (5 x 4 B), one 32 B row read and one 4 B HOTNESS
    # word written per distinct page, a 4 B WEAR word per distinct slow
    # frame written (bounded by the writes), and on decay chunks the
    # whole HOTNESS lane read and written plus the slow WEAR lane read.
    byts = 0
    for c in range(n_chunks):
        pg = sub.page[c * cfg.chunk:(c + 1) * cfg.chunk]
        uniq = int(torch.unique(pg).numel())
        writes = int(sub.is_write[c * cfg.chunk:(c + 1) * cfg.chunk].sum())
        byts += cfg.chunk * 40 + uniq * (32 + 4) + min(writes, uniq) * 4
        if c % cfg.decay_every == cfg.decay_every - 1:
            byts += cfg.n_pages * 8 + cfg.n_slow_pages * 4
    bound_ms = byts / n_chunks / HBM_BYTES_PER_S * 1e3
    print(f"  kernel B on the first {n_chunks} main-path chunks: "
          f"{k_ms * 1e3:.2f} us/launch (device); plain version "
          f"{p_ms:.3f} ms/chunk (wall, {n_plain} chunks); bound "
          f"{bound_ms * 1e6:.1f} ns/chunk ({byts / n_chunks:.0f} B)")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms}


def kernel_a_main_ms(torch, rt, hl, main, n_chunks=256) -> float:
    """Kernel A's device time per launch on the scan path's real
    inputs (the first chunks of the main trace)."""
    cfg, trace = main["cfg"], main["trace"]
    n_chunks = min(n_chunks, len(trace) // cfg.chunk)
    sub = rt.core.Trace(*(x[:n_chunks * cfg.chunk] for x in trace))
    eng = rt.Engine(cfg.with_(chunk_step_kernel="off"))
    ms = device_ms(torch, lambda: eng.run(sub), 1, "hmmu_lookup_kernel") \
        / n_chunks
    print(f"  kernel A on the first {n_chunks} main-path chunks: "
          f"{ms * 1e3:.2f} us/launch (device)")
    return ms


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch as rt
        from repro_torch.kernels import build
        from repro_torch.kernels import chunk_step as cs
        from repro_torch.kernels import hmmu_lookup as hl
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    try:
        dev = cuda_device(torch)
        card = card_line()
        print(f"[1] device: {card}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}", flush=True)

        t0 = time.perf_counter()
        build.build_all([hl.KERNEL, cs.KERNEL])
        print(f"[2] build: {time.perf_counter() - t0:.1f} s -> "
              f"{build.BUILD_DIR}", flush=True)
        for k in (hl.KERNEL, cs.KERNEL):
            info = [ln.strip() for ln in k.build_log.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"    {k.name}: {k.library.name}; {' | '.join(info)}")

        print("[3] kernel A (hmmu_lookup) against its plain version",
              flush=True)
        a = check_lookup(torch, dev, hl)

        print("[4] kernel B (chunk_step) against its plain version",
              flush=True)
        b = check_chunk_step(torch, dev, rt, cs)

        print("[5] the main path at full size", flush=True)
        main_run = run_main_path(torch, dev, rt, hl, cs)
        b_num = kernel_b_numbers(torch, dev, rt, cs, main_run)
        a_main_ms = kernel_a_main_ms(torch, rt, hl, main_run)

        k_ms, p_ms, lib_ms, a_bound = a["timing"][(1, 514)]
        counts = {route: main_run["results"][route][1]
                  for route in ("auto", "off")}
        kernels = [
            {"name": "hmmu_lookup", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/hmmu_lookup.cu",
             "replaces": "src/repro/kernels/hmmu_lookup.py:78",
             "launches": counts["off"]["hmmu_lookup"],
             "max_abs_err": a["max_abs_err"], "ms": a_main_ms,
             "plain_ms": p_ms, "bound_ms": a_bound, "bound_by": "bytes",
             "library_ms": lib_ms},
            {"name": "chunk_step", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/chunk_step.cu",
             "replaces": "src/repro/kernels/chunk_step.py:793",
             "launches": counts["auto"]["chunk_step"],
             "max_abs_err": b["max_abs_err"], "ms": b_num["ms"],
             "plain_ms": b_num["plain_ms"], "bound_ms": b_num["bound_ms"],
             "bound_by": "bytes", "library_ms": None},
        ]
        print(f"    kernel A alone at B=1 m=514: {k_ms * 1e3:.2f} us")
        print(json.dumps({"kernels": kernels}))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except Exception:  # a boundary that reports: any failure is nonzero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
