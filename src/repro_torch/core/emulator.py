"""The HMMU emulation pipeline (PyTorch port of ``repro.core.emulator``).

Requests flow through the paper's Fig 2 stages (RX link -> table lookup
-> DMA-conflict redirect -> bank queues -> media -> tag-match in-order
return -> TX link) one chunk at a time in ``kernels.chunk_step``; this
module loops that step over the trace's chunks (the JAX package's
``lax.scan``) and folds each chunk's results into the counters. Drive it
through :class:`repro_torch.Engine`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import counters as counters_lib, dma as dma_lib, table as table_lib
from .config import EmulatorConfig, RuntimeParams
from .faults import FaultPlan
from .policies import PolicyRegistry
from ..kernels import chunk_step as chunk_step_lib


class Trace(NamedTuple):
    """A memory-request trace (struct of 1-D tensors)."""
    page: torch.Tensor      # int32 flat page number
    offset: torch.Tensor    # int32 byte offset within the page
    is_write: torch.Tensor  # bool
    size: torch.Tensor      # int32 bytes (usually the 64 B line)

    def __len__(self):
        return self.page.shape[-1]

    def to(self, device) -> "Trace":
        return Trace(*(x.to(device) for x in self))


class EmulatorState(NamedTuple):
    table: torch.Tensor       # int32[n_pages, table.ROW_W] packed metadata
    clock_ptr: torch.Tensor   # int32 — CLOCK victim pointer over fast frames
    chunk_idx: torch.Tensor   # int32 — chunks processed
    dma: dma_lib.DMAState
    clock: torch.Tensor       # int32 cycles
    bank_free: torch.Tensor   # int32[2 * n_banks] — per device x bank
    link_free_rx: torch.Tensor
    link_free_tx: torch.Tensor
    last_return: torch.Tensor
    counters: counters_lib.Counters
    rescue_page: torch.Tensor  # int32 — page awaiting rescue (-1 idle)
    min_wear: torch.Tensor     # int32 — global min slow-frame WEAR
    fault_cursor: torch.Tensor  # int32 — next unconsumed FaultPlan death


def init_state(cfg: EmulatorConfig, params: RuntimeParams | None = None,
               device=None) -> EmulatorState:
    """Fresh platform state (tier boundary and pinned fraction from
    ``params`` when given, else from ``cfg``). Every field is its own
    tensor, so the state can be updated in place."""
    if params is not None:
        device = params.n_fast_pages.device
    nf = None if params is None else params.n_fast_pages
    pin = None if params is None else params.pin_fast_fraction

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return EmulatorState(
        table=table_lib.init_table(cfg, nf, pin, device=device),
        clock_ptr=i32(0), chunk_idx=i32(0),
        dma=dma_lib.DMAState.idle(device),
        clock=i32(0),
        bank_free=torch.zeros(2 * cfg.n_banks, dtype=torch.int32,
                              device=device),
        link_free_rx=i32(0), link_free_tx=i32(0), last_return=i32(0),
        counters=counters_lib.Counters.zeros(device),
        rescue_page=i32(-1), min_wear=i32(0), fault_cursor=i32(0),
    )


def clone_state(state: EmulatorState) -> EmulatorState:
    """A deep copy of ``state`` (every tensor cloned)."""
    def c(x):
        return type(x)(*(c(y) for y in x)) if isinstance(x, tuple) \
            else x.clone()
    return c(state)


def pad_trace(cfg: EmulatorConfig, t: Trace) -> tuple[Trace, torch.Tensor]:
    """Pad to a multiple of cfg.chunk; returns (trace, valid mask)."""
    n = len(t)
    rem = (-n) % cfg.chunk
    valid = torch.arange(n + rem, device=t.page.device) < n
    if rem:
        t = Trace(*(torch.cat([x, x.new_zeros(rem)]) for x in t))
    return t, valid


def _chunk_step(cfg: EmulatorConfig, params: RuntimeParams,
                registry: PolicyRegistry, faults: FaultPlan,
                state: EmulatorState, trace: Trace, valid: torch.Tensor):
    """One chunk through the chunk step, then the counter update (float
    accumulation stays outside the kernel)."""
    page, offset, is_write, size = trace
    size = torch.where(valid, size, 0)
    sc = chunk_step_lib.StepScalars(
        clock=state.clock, clock_ptr=state.clock_ptr,
        chunk_idx=state.chunk_idx, dma=state.dma,
        link_free_rx=state.link_free_rx, link_free_tx=state.link_free_tx,
        last_return=state.last_return, rescue_page=state.rescue_page,
        min_wear=state.min_wear, fault_cursor=state.fault_cursor)
    table, sc, bank_free, outs = chunk_step_lib.chunk_step(
        cfg, registry, state.table, params, sc, state.bank_free,
        page, offset, is_write, size, valid, faults)
    ctr = counters_lib.update(params, state.counters, device=outs["device"],
                              is_write=is_write, size=size, valid=valid,
                              latency=outs["latency"], held=outs["held"],
                              poisoned=outs["poisoned"],
                              retired=outs["retired"] >= 0,
                              injected=outs["injected"])
    new_state = EmulatorState(
        table=table, clock_ptr=sc.clock_ptr, chunk_idx=sc.chunk_idx,
        dma=sc.dma, clock=sc.clock, bank_free=bank_free,
        link_free_rx=sc.link_free_rx, link_free_tx=sc.link_free_tx,
        last_return=sc.last_return, counters=ctr,
        rescue_page=sc.rescue_page, min_wear=sc.min_wear,
        fault_cursor=sc.fault_cursor)
    n = page.shape[0]
    out = {"returns": outs["returns"],
           "device": torch.where(valid, outs["device"], -1),
           "latency": outs["latency"],
           "faulted": (outs["poisoned"] | outs["injected"]) & valid,
           "retired_page": outs["retired"].expand(n),
           "tombstone": outs["tombstone"].expand(n)}
    return new_state, out


def _emulate_impl(cfg: EmulatorConfig, registry: PolicyRegistry, trace: Trace,
                  valid: torch.Tensor, state: EmulatorState,
                  params: RuntimeParams, faults: FaultPlan | None = None
                  ) -> tuple[EmulatorState, dict]:
    """Loop the chunk step over a chunk-multiple trace. ``state.table`` is
    updated in place."""
    if faults is None:
        faults = FaultPlan.empty(device=state.table.device)
    n = len(trace)
    if n % cfg.chunk:
        raise ValueError("pad the trace to a chunk multiple first")
    parts = []
    for lo in range(0, n, cfg.chunk):
        sl = slice(lo, lo + cfg.chunk)
        state, out = _chunk_step(cfg, params, registry, faults, state,
                                 Trace(*(x[sl] for x in trace)), valid[sl])
        parts.append(out)
    if not parts:
        z = torch.zeros(0, dtype=torch.int32, device=state.table.device)
        return state, {"returns": z, "device": z, "latency": z,
                       "faulted": z.bool(), "retired_page": z,
                       "tombstone": z}
    return state, {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
