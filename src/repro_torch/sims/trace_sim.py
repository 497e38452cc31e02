"""ChampSim-class baseline: a sequential, per-request software simulator.

Implements exactly the chunk=1 semantics of the emulation pipeline
(repro_torch.core.emulator), one request at a time in a numpy / Python
loop on the host — the software-simulator methodology the paper compares
against. Because the semantics match, this module is also the *oracle*
for the port's correctness checks: a chunk=1 ``repro_torch.Engine.run``,
on the CPU or through the chunk-step kernel, must be bit-identical to
this loop (tests/test_torch_engine.py, chip_smoke.py phase 13).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.config import EmulatorConfig, FAST, SLOW
from repro_torch.core.table import HOTNESS_CAP


@dataclass
class SimResult:
    returns: np.ndarray
    latency: np.ndarray
    device: np.ndarray
    clock: int
    swaps: int
    counters: dict = field(default_factory=dict)


def _ceil_div(size: int, bpc: float) -> int:
    return int(math.ceil(size / bpc))


def exchange_cycles_per_subblock(cfg: EmulatorConfig) -> int:
    """Cycles to exchange one sub-block (A->buffer, B->A, buffer->B), a
    host int from ``cfg`` (the port's ``core.dma`` takes the tensors of
    ``RuntimeParams``)."""
    return 3 * cfg.dma_cycles_per_subblock


def swap_duration(cfg: EmulatorConfig) -> int:
    """Cycles of one whole page swap, a host int from ``cfg``."""
    return cfg.subblocks_per_page * exchange_cycles_per_subblock(cfg)


def simulate(cfg: EmulatorConfig, page, offset, is_write, size) -> SimResult:
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
    dma_active, dma_a, dma_b, dma_start, swaps = False, -1, -1, 0, 0
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
        raise NotImplementedError(
            f"oracle mirrors static/hotness/write_bias, not {cfg.policy!r}")

    for i in range(n):
        p, off, w, sz = int(page[i]), int(offset[i]), bool(is_write[i]), int(size[i])

        # --- RX link
        issue = clock + cfg.issue_gap
        rx_b = sz if w else 16
        rx_done = max(issue, link_rx) + _ceil_div(rx_b, cfg.link_bytes_per_cycle)
        link_rx = rx_done
        arrive = rx_done + cfg.link_lat // 2

        # --- table lookup + DMA conflict redirect (paper §III-D)
        d, f = int(device[p]), int(frame[p])
        if dma_active and p in (dma_a, dma_b):
            prog = min(max((arrive - dma_start) // exch, 0), spp)
            if off // cfg.subblock < prog:
                other = dma_b if p == dma_a else dma_a
                d, f = int(device[other]), int(frame[other])

        # --- bank queue + media access
        tech = cfg.slow if d == SLOW else cfg.fast
        srv = (tech.write_lat if w else tech.read_lat) + \
            _ceil_div(sz, tech.bytes_per_cycle)
        lane = d * cfg.n_banks + f % cfg.n_banks
        med_done = max(arrive, int(bank_free[lane])) + srv
        bank_free[lane] = med_done

        # --- tag-match in-order return, then TX link
        ordered = max(med_done, last_ret)
        if ordered > med_done:
            ctr["reorder_held"] += 1
        tx_b = 16 if w else sz
        ret = max(ordered, link_tx) + _ceil_div(tx_b, cfg.link_bytes_per_cycle)
        link_tx = ret
        ret += cfg.link_lat // 2

        returns[i] = ret
        latency[i] = ret - issue
        dev_out[i] = d

        # --- counters (per post-redirect device, like the FPGA counters)
        key = ("writes_" if w else "reads_") + ("slow" if d == SLOW else "fast")
        ctr[key] += 1
        ctr["bytes_written" if w else "bytes_read"] += sz
        if d == SLOW:
            ctr["energy_pj"] += 8.0 * sz * (
                cfg.power_pj_per_bit_slow_write if w else cfg.power_pj_per_bit_slow_read)
        else:
            ctr["energy_pj"] += 8.0 * sz * cfg.power_pj_per_bit_fast

        # --- chunk boundary (chunk == 1): hotness, DMA, policy.
        # write_weight is policy-scoped: only write_bias biases hotness.
        ww = cfg.write_weight if cfg.policy == "write_bias" else 1
        # Saturating like the emulator's HOTNESS lane (identity below cap).
        hotness[p] = min(hotness[p] + 1 + (ww - 1) * int(w),
                         HOTNESS_CAP)
        if i % cfg.decay_every == cfg.decay_every - 1:
            hotness >>= cfg.hotness_decay_shift

        last_ret = ret
        now = max(clock + cfg.issue_gap, ret)

        if dma_active and now >= dma_start + dur:
            device[dma_a], device[dma_b] = device[dma_b], device[dma_a]
            frame[dma_a], frame[dma_b] = frame[dma_b], frame[dma_a]
            if device[dma_a] == FAST:  # promoted page now owns its frame
                fast_owner[frame[dma_a]] = dma_a
            dma_active, dma_a, dma_b = False, -1, -1
            swaps += 1

        if cfg.policy in ("hotness", "write_bias"):
            # chunk-local candidate (the single request) + CLOCK victim
            heat = int(hotness[p]) if device[p] == SLOW else -1
            cand = p
            victim = int(fast_owner[clock_ptr])
            want = (heat >= cfg.hot_threshold and heat > int(hotness[victim])
                    and device[cand] == SLOW and device[victim] == FAST)
            # The CLOCK pointer commits only with an accepted + started
            # proposal (engine idle): a dropped proposal must not skip
            # its victim frame (matches the emulator's pointer commit).
            if want and not dma_active:
                dma_active, dma_a, dma_b, dma_start = True, cand, victim, now
                clock_ptr = (clock_ptr + 1) % cfg.n_fast_pages

        clock = now

    ctr["mean_read_latency_cyc"] = (
        float(latency[~is_write.astype(bool)].mean()) if (~is_write.astype(bool)).any() else 0.0)
    return SimResult(returns=returns, latency=latency, device=dev_out,
                     clock=clock, swaps=swaps, counters=ctr)
