"""gem5-class baseline: an event-driven, cycle-level software simulator.

Every pipeline stage of every request, every DMA sub-block transfer and
(optionally) every DRAM refresh window is a discrete event on a heap —
the detailed-but-sequential methodology whose slowness motivates the
paper's platform.

With ``refresh=False`` the timing semantics are *identical* to
``trace_sim`` (and hence to a chunk=1 ``repro_torch.Engine`` session);
tests/test_torch_sims.py holds both against each other and against the
JAX package's simulators. ``refresh=True`` adds tREFI/tRFC DRAM refresh
modelling — extra fidelity the flat simulators lack.
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.config import EmulatorConfig, FAST, SLOW
from repro_torch.core.table import HOTNESS_CAP
from .trace_sim import (SimResult, _ceil_div, exchange_cycles_per_subblock,
                        swap_duration)


def simulate(cfg: EmulatorConfig, page, offset, is_write, size,
             refresh: bool = False, tREFI: int = 7800, tRFC: int = 350,
             cpu_model: bool = False, insns_per_request: int = 12
             ) -> SimResult:
    """``cpu_model=True`` additionally simulates the host CPU pipeline the
    way gem5 SE-mode does: every memory request is surrounded by the
    retirement events of the non-memory instructions between misses
    (``insns_per_request``, ~ SPEC's MPKI). Timing-neutral with respect to
    the memory system (instructions retire in the issue gap), but it is
    the dominant *simulation* cost — exactly the overhead the paper
    escapes by running applications on real hard-IP cores."""
    page = np.asarray(page)
    offset = np.asarray(offset)
    is_write = np.asarray(is_write)
    size = np.asarray(size)
    n = len(page)

    n_pages = cfg.n_pages
    device = np.where(np.arange(n_pages) < cfg.n_fast_pages, FAST, SLOW)
    frame = np.where(np.arange(n_pages) < cfg.n_fast_pages,
                     np.arange(n_pages), np.arange(n_pages) - cfg.n_fast_pages)
    hotness = np.zeros(n_pages, np.int64)
    fast_owner = np.arange(cfg.n_fast_pages, dtype=np.int64)
    clock_ptr = 0

    bank_free = np.zeros(2 * cfg.n_banks, np.int64)
    link_rx = link_tx = last_ret = clock = 0
    dma = {"active": False, "a": -1, "b": -1, "start": 0, "progress": 0}
    swaps = 0
    exch = exchange_cycles_per_subblock(cfg)
    dur = swap_duration(cfg)
    spp = cfg.subblocks_per_page

    returns = np.zeros(n, np.int64)
    latency = np.zeros(n, np.int64)
    dev_out = np.zeros(n, np.int64)
    ctr = {"reads_fast": 0, "writes_fast": 0, "reads_slow": 0,
           "writes_slow": 0, "bytes_read": 0, "bytes_written": 0,
           "reorder_held": 0, "energy_pj": 0.0}

    if cfg.policy not in ("static", "hotness", "write_bias"):
        raise NotImplementedError(cfg.policy)

    heap: list = []
    seq = 0

    def push(t, kind, data):
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, data))
        seq += 1

    req = {}  # in-flight request scratch

    retired = 0

    def start_request(i, t_clock):
        issue = t_clock + cfg.issue_gap
        if cpu_model:
            # Retire the instruction window between the previous miss and
            # this one, one pipeline event each (gem5-style per-insn cost).
            for k in range(insns_per_request):
                push(t_clock + (k * cfg.issue_gap) // max(1, insns_per_request),
                     "cpu", k)
        push(issue, "issue", i)
        req["issue"] = issue

    if refresh:
        for d in range(2):
            push(tREFI, "refresh", d)

    start_request(0, clock)

    while heap:
        t, _, kind, data = heapq.heappop(heap)

        if kind == "refresh":
            d = data
            end = t + tRFC
            for b in range(cfg.n_banks):
                lane = d * cfg.n_banks + b
                bank_free[lane] = max(bank_free[lane], end)
            push(t + tREFI, "refresh", d)
            if not heap or all(k == "refresh" for _, _, k, _ in heap):
                break  # only refresh events left -> done
            continue

        if kind == "cpu":
            retired += 1  # scoreboard update; no memory-system interaction
            continue

        if kind == "dma_blk":
            dma["progress"] += 1
            if dma["progress"] >= spp:
                a, b = dma["a"], dma["b"]
                device[a], device[b] = device[b], device[a]
                frame[a], frame[b] = frame[b], frame[a]
                if device[a] == FAST:
                    fast_owner[frame[a]] = a
                dma.update(active=False, a=-1, b=-1, progress=0)
                swaps += 1
            continue

        i = data
        if kind == "issue":
            w, sz = bool(is_write[i]), int(size[i])
            rx_b = sz if w else 16
            rx_done = max(t, link_rx) + _ceil_div(rx_b, cfg.link_bytes_per_cycle)
            link_rx = rx_done
            push(rx_done + cfg.link_lat // 2, "arrive", i)
            continue

        if kind == "arrive":
            p, off = int(page[i]), int(offset[i])
            w, sz = bool(is_write[i]), int(size[i])
            d, f = int(device[p]), int(frame[p])
            if dma["active"] and p in (dma["a"], dma["b"]):
                if off // cfg.subblock < dma["progress"]:
                    other = dma["b"] if p == dma["a"] else dma["a"]
                    d, f = int(device[other]), int(frame[other])
            tech = cfg.slow if d == SLOW else cfg.fast
            srv = (tech.write_lat if w else tech.read_lat) + \
                _ceil_div(sz, tech.bytes_per_cycle)
            lane = d * cfg.n_banks + f % cfg.n_banks
            med_done = max(t, int(bank_free[lane])) + srv
            bank_free[lane] = med_done
            req["dev"], req["med_done"] = d, med_done
            push(med_done, "med_done", i)
            continue

        if kind == "med_done":
            w, sz = bool(is_write[i]), int(size[i])
            ordered = max(t, last_ret)
            if ordered > t:
                ctr["reorder_held"] += 1
            tx_b = 16 if w else sz
            ret = max(ordered, link_tx) + _ceil_div(tx_b, cfg.link_bytes_per_cycle)
            link_tx = ret
            push(ret + cfg.link_lat // 2, "ret", i)
            continue

        if kind == "ret":
            p = int(page[i])
            w, sz = bool(is_write[i]), int(size[i])
            d = req["dev"]
            returns[i] = t
            latency[i] = t - req["issue"]
            dev_out[i] = d
            key = ("writes_" if w else "reads_") + ("slow" if d == SLOW else "fast")
            ctr[key] += 1
            ctr["bytes_written" if w else "bytes_read"] += sz
            if d == SLOW:
                ctr["energy_pj"] += 8.0 * sz * (
                    cfg.power_pj_per_bit_slow_write if w
                    else cfg.power_pj_per_bit_slow_read)
            else:
                ctr["energy_pj"] += 8.0 * sz * cfg.power_pj_per_bit_fast

            # write_weight is policy-scoped: only write_bias biases hotness.
            ww = cfg.write_weight if cfg.policy == "write_bias" else 1
            # Saturating like the emulator's HOTNESS lane (identity below
            # the cap).
            hotness[p] = min(hotness[p] + 1 + (ww - 1) * int(w),
                             HOTNESS_CAP)
            if i % cfg.decay_every == cfg.decay_every - 1:
                hotness >>= cfg.hotness_decay_shift
            last_ret = t
            now = max(clock + cfg.issue_gap, t)

            if cfg.policy in ("hotness", "write_bias"):
                heat = int(hotness[p]) if device[p] == SLOW else -1
                cand = p
                victim = int(fast_owner[clock_ptr])
                want = (heat >= cfg.hot_threshold
                        and heat > int(hotness[victim])
                        and device[cand] == SLOW and device[victim] == FAST)
                # Pointer commits only with a started swap (see trace_sim).
                if want and not dma["active"]:
                    dma.update(active=True, a=cand, b=victim,
                               start=now, progress=0)
                    clock_ptr = (clock_ptr + 1) % cfg.n_fast_pages
                    for k in range(1, spp + 1):
                        push(now + k * exch, "dma_blk", None)

            clock = now
            if i + 1 < n:
                start_request(i + 1, clock)
            continue

    rd = ~is_write.astype(bool)
    ctr["mean_read_latency_cyc"] = float(latency[rd].mean()) if rd.any() else 0.0
    return SimResult(returns=returns, latency=latency, device=dev_out,
                     clock=clock, swaps=swaps, counters=ctr)
