"""The emulation loop in plain PyTorch: every design point's fresh state,
then one :func:`chunk_step.step_batch` a chunk for all points and the
counter fold (a frozen copy of the emulator's plain chunk loop)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import chunk_step as chunk_step_lib
from . import counters as counters_lib, dma as dma_lib, table as table_lib
from .config import EmulatorConfig, RuntimeParams
from .faults import FaultPlan
from .policies import PolicyRegistry


class Trace(NamedTuple):
    """A memory-request trace (struct of 1-D tensors)."""
    page: torch.Tensor      # int32 flat page number
    offset: torch.Tensor    # int32 byte offset within the page
    is_write: torch.Tensor  # bool
    size: torch.Tensor      # int32 bytes (usually the 64 B line)

    def __len__(self):
        return self.page.shape[-1]


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


def _fresh_fields(cfg: EmulatorConfig, device, lead=()) -> dict:
    """Every field of a fresh state after the table, each with the leading
    shape ``lead`` and its own storage."""
    def grow(x):
        if isinstance(x, tuple):
            return type(x)(*(grow(y) for y in x))
        return x.expand((*lead, *x.shape)).clone()

    def i32(v):
        return torch.full(lead, v, dtype=torch.int32, device=device)

    return dict(
        clock_ptr=i32(0), chunk_idx=i32(0),
        dma=grow(dma_lib.DMAState.idle(device)),
        clock=i32(0),
        bank_free=torch.zeros(*lead, 2 * cfg.n_banks, dtype=torch.int32,
                              device=device),
        link_free_rx=i32(0), link_free_tx=i32(0), last_return=i32(0),
        counters=grow(counters_lib.Counters.zeros(device)),
        rescue_page=i32(-1), min_wear=i32(0), fault_cursor=i32(0),
    )


def init_states(cfg: EmulatorConfig, params: RuntimeParams) -> EmulatorState:
    """Fresh state of every design point of the stacked ``params`` (1-D
    tensors of length B), stacked: each point's table from its own
    ``n_fast_pages`` and ``pin_fast_fraction``."""
    table = table_lib.init_table(cfg, params.n_fast_pages[:, None],
                                 params.pin_fast_fraction[:, None])
    return EmulatorState(table=table, **_fresh_fields(
        cfg, table.device, params.policy_id.shape))


def pad_trace(cfg: EmulatorConfig, t: Trace) -> tuple[Trace, torch.Tensor]:
    """Pad to a multiple of cfg.chunk; returns (trace, valid mask)."""
    n = len(t)
    rem = (-n) % cfg.chunk
    valid = torch.arange(n + rem, device=t.page.device) < n
    if rem:
        t = Trace(*(torch.cat([x, x.new_zeros(rem)]) for x in t))
    return t, valid


def _step_scalars(state: EmulatorState) -> chunk_step_lib.StepScalars:
    return chunk_step_lib.StepScalars(
        clock=state.clock, clock_ptr=state.clock_ptr,
        chunk_idx=state.chunk_idx, dma=state.dma,
        link_free_rx=state.link_free_rx, link_free_tx=state.link_free_tx,
        last_return=state.last_return, rescue_page=state.rescue_page,
        min_wear=state.min_wear, fault_cursor=state.fault_cursor)


def _chunk_step(cfg: EmulatorConfig, params: RuntimeParams,
                registry: PolicyRegistry, faults: FaultPlan,
                state: EmulatorState, trace: Trace, valid: torch.Tensor,
                update):
    """One chunk of B design points (stacked ``state`` and ``params``,
    request vectors and ``valid`` [B, chunk]) through ``step_batch``,
    then the counter fold ``update`` (:func:`counters.update`)."""
    page, offset, is_write, size = trace
    size = torch.where(valid, size, 0)
    table, sc, bank_free, outs = chunk_step_lib.step_batch(
        cfg, registry, state.table, params, _step_scalars(state),
        state.bank_free, page, offset, is_write, size, valid, faults)
    ctr = update(params, state.counters, device=outs["device"],
                 is_write=is_write, size=size, valid=valid,
                 latency=outs["latency"], held=outs["held"],
                 poisoned=outs["poisoned"], retired=outs["retired"] >= 0,
                 injected=outs["injected"])
    new_state = EmulatorState(
        table=table, clock_ptr=sc.clock_ptr, chunk_idx=sc.chunk_idx,
        dma=sc.dma, clock=sc.clock, bank_free=bank_free,
        link_free_rx=sc.link_free_rx, link_free_tx=sc.link_free_tx,
        last_return=sc.last_return, counters=ctr,
        rescue_page=sc.rescue_page, min_wear=sc.min_wear,
        fault_cursor=sc.fault_cursor)
    shape = page.shape
    out = {"returns": outs["returns"],
           "device": torch.where(valid, outs["device"], -1),
           "latency": outs["latency"],
           "faulted": (outs["poisoned"] | outs["injected"]) & valid,
           "retired_page": outs["retired"][..., None].expand(shape),
           "tombstone": outs["tombstone"][..., None].expand(shape)}
    return new_state, out


def emulate(cfg: EmulatorConfig, registry: PolicyRegistry, trace: Trace,
            params: RuntimeParams, update=counters_lib.update
            ) -> tuple[EmulatorState, dict]:
    """Every design point of the stacked ``params`` (1-D tensors of
    length B) from a fresh state over the whole ``trace`` ([N], shared by
    every point; padded here to a chunk multiple): one chunk loop, each
    chunk ONE ``step_batch`` for all points. Returns the final stacked
    states and the [B, N_padded] outputs."""
    trace, valid = pad_trace(cfg, trace)
    states = init_states(cfg, params)
    faults = FaultPlan.empty(device=states.table.device)
    b = states.table.shape[0]
    trace = Trace(*(x.expand(b, -1) for x in trace))
    valid = valid.expand(b, -1)
    new, parts = states, []
    for lo in range(0, len(trace), cfg.chunk):
        sl = slice(lo, lo + cfg.chunk)
        new, out = _chunk_step(cfg, params, registry, faults, new,
                               Trace(*(x[:, sl] for x in trace)),
                               valid[:, sl], update)
        parts.append(out)
    return new, {k: torch.cat([p[k] for p in parts], dim=-1)
                 for k in parts[0]}
