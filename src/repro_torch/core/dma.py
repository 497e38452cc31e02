"""DMA page-migration engine with swap-progress conflict redirection
(paper §III-D), PyTorch port of ``repro.core.dma``.

The engine swaps two pages (one per device) in 512 B sub-blocks. A
request that hits a page mid-swap is redirected by the progress
indicator: if its sub-block has already been exchanged it goes to the
counterpart's (pre-swap) location. One swap is in flight at a time.

Every function takes one design point (0-dim state fields, rows [W],
request vectors [n]) or B of them along a leading point axis (fields
[B], rows [B, W], vectors [B, n], a table [B, n_pages, W]).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import table as table_lib
from .config import SLOW, EmulatorConfig, RuntimeParams
from .indexing import take_lane, take_rows


class DMAState(NamedTuple):
    active: torch.Tensor      # int32 {0,1}
    page_a: torch.Tensor      # int32 — first swap member (-1 when idle)
    page_b: torch.Tensor      # int32 — second swap member (-1 when idle)
    start: torch.Tensor       # int32 cycle at which the swap began
    swaps_done: torch.Tensor  # int32 counter — completed migrations

    @staticmethod
    def idle(device=None) -> "DMAState":
        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=device)
        return DMAState(active=i32(0), page_a=i32(-1), page_b=i32(-1),
                        start=i32(0), swaps_done=i32(0))


def exchange_cycles_per_subblock(params: RuntimeParams) -> torch.Tensor:
    """Cycles to exchange one sub-block (A->buffer, B->A, buffer->B)."""
    return 3 * params.dma_cycles_per_subblock


def swap_duration(cfg: EmulatorConfig, params: RuntimeParams) -> torch.Tensor:
    return cfg.subblocks_per_page * exchange_cycles_per_subblock(params)


def progress_subblocks(cfg: EmulatorConfig, dma: DMAState, t: torch.Tensor,
                       params: RuntimeParams) -> torch.Tensor:
    """Number of fully exchanged sub-blocks at the request times ``t``
    [..., n] (int32, clamped). ``//`` floors, as in the JAX package."""
    raw = (t - dma.start[..., None]) // \
        exchange_cycles_per_subblock(params)[..., None]
    raw = torch.where(dma.active[..., None] == 1, raw, 0)
    return raw.clamp(0, cfg.subblocks_per_page)


def redirect(cfg: EmulatorConfig, dma: DMAState,
             page: torch.Tensor, offset: torch.Tensor, t: torch.Tensor,
             device: torch.Tensor, frame: torch.Tensor,
             row_a: torch.Tensor, row_b: torch.Tensor,
             params: RuntimeParams) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply swap-progress redirection to a chunk of requests; returns
    the (device, frame) each request actually accesses. ``row_a`` /
    ``row_b`` are the pre-swap table rows of the in-flight pair."""
    prog = progress_subblocks(cfg, dma, t, params)
    transferred = (offset // cfg.subblock) < prog
    active = dma.active[..., None] == 1
    hit_a = active & (page == dma.page_a[..., None]) & transferred
    hit_b = active & (page == dma.page_b[..., None]) & transferred
    device = torch.where(hit_a, table_lib.device(row_b)[..., None], device)
    frame = torch.where(hit_a, table_lib.frame(row_b)[..., None], frame)
    device = torch.where(hit_b, table_lib.device(row_a)[..., None], device)
    frame = torch.where(hit_b, table_lib.frame(row_a)[..., None], frame)
    return device, frame


class SwapCommit(NamedTuple):
    """A swap commit as data: the new engine state plus the table writes
    as (row, lane, int32 delta) scatter-add triples computed from the
    prefetched pre-chunk rows."""
    dma: DMAState
    done: torch.Tensor       # bool — swap finished this boundary
    rows: torch.Tensor       # int32[..., 10] target rows (idle: row 0)
    lanes: torch.Tensor      # int32[10] target lanes (every point's)
    delta: torch.Tensor      # int32[..., 10] value to add at (row, lane)
    tombstone: torch.Tensor  # int32 — page parked on a dead frame, else -1
    rescued: torch.Tensor    # int32 — page whose rescue completed, else -1


def plan_commit(cfg: EmulatorConfig, dma: DMAState, now: torch.Tensor,
                row_a: torch.Tensor, row_b: torch.Tensor,
                params: RuntimeParams, rescue_page=None) -> SwapCommit:
    """Plan the chunk-boundary swap commit from prefetched rows (see
    ``repro.core.dma.plan_commit`` for the semantics: lane exchange, EPOCH
    stamp, WEAR charge of the slow destination, and poison travel for the
    page in the rescue register)."""
    dev = now.device
    done = (dma.active == 1) & (now >= dma.start + swap_duration(cfg, params))
    a, b = dma.page_a, dma.page_b
    ia = torch.where(a >= 0, a, 0)
    ib = torch.where(b >= 0, b, 0)
    da, db = table_lib.device(row_a), table_lib.device(row_b)
    fa, fb = table_lib.frame(row_a), table_lib.frame(row_b)
    ea, eb = table_lib.epoch(row_a), table_lib.epoch(row_b)
    commit_a = done & (a >= 0)
    commit_b = done & (b >= 0)

    charge = cfg.page_size // cfg.line_size
    chg_a = commit_a & (db == SLOW)   # a demoted into slow frame fb
    chg_b = commit_b & (da == SLOW)   # b demoted into slow frame fa

    rp = torch.as_tensor(-1 if rescue_page is None else rescue_page,
                         dtype=torch.int32, device=dev)
    fla, flb = table_lib.flags(row_a), table_lib.flags(row_b)
    dead_a = ((fla & table_lib.POISONED) != 0) & (a == rp) & (a >= 0)
    dead_b = ((flb & table_lib.POISONED) != 0) & (b == rp) & (b >= 0)
    dead_bits = table_lib.POISONED | table_lib.RETIRED
    new_fla = torch.where(dead_b, (fla | dead_bits) & ~table_lib.PINNED,
                          torch.where(dead_a, fla & ~dead_bits, fla))
    new_flb = torch.where(dead_a, (flb | dead_bits) & ~table_lib.PINNED,
                          torch.where(dead_b, flb & ~dead_bits, flb))

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    rows = torch.stack([ia, ib, ia, ib, ia, ib,
                        torch.where(chg_a, fb, zero),
                        torch.where(chg_b, fa, zero), ia, ib], dim=-1)
    k = torch.arange(5, dtype=torch.int32, device=dev).repeat_interleave(2)
    lanes = table_lib.swap_commit_lanes(k)
    delta = torch.stack([torch.where(commit_a, db - da, zero),
                         torch.where(commit_b, da - db, zero),
                         torch.where(commit_a, fb - fa, zero),
                         torch.where(commit_b, fa - fb, zero),
                         torch.where(commit_a, now - ea, zero),
                         torch.where(commit_b, now - eb, zero),
                         torch.where(chg_a, charge, zero),
                         torch.where(chg_b, charge, zero),
                         torch.where(commit_a, new_fla - fla, zero),
                         torch.where(commit_b, new_flb - flb, zero)],
                        dim=-1)

    any_dead = (commit_a & dead_a) | (commit_b & dead_b)
    none = torch.full((), -1, dtype=torch.int32, device=dev)
    tombstone = torch.where(any_dead, torch.where(dead_a, b, a), none)
    rescued = torch.where(any_dead, torch.where(dead_a, a, b), none)

    new = DMAState(
        active=torch.where(done, zero, dma.active),
        page_a=torch.where(done, none, dma.page_a),
        page_b=torch.where(done, none, dma.page_b),
        start=dma.start,
        swaps_done=dma.swaps_done + done.to(torch.int32),
    )
    return SwapCommit(dma=new, done=done, rows=rows, lanes=lanes,
                      delta=delta, tombstone=tombstone, rescued=rescued)


def maybe_complete(cfg: EmulatorConfig, dma: DMAState, now: torch.Tensor,
                   table: torch.Tensor, params: RuntimeParams,
                   rescue_page=None
                   ) -> tuple[DMAState, torch.Tensor, torch.Tensor]:
    """Standalone commit: gather the swap pair's rows, plan the commit,
    apply its deltas (WEAR saturating at WEAR_CAP) to a copy of
    ``table``. Returns (state, table, done_flag)."""
    plan = plan_commit(cfg, dma, now,
                       take_rows(table, dma.page_a.clamp_min(0)),
                       take_rows(table, dma.page_b.clamp_min(0)), params,
                       rescue_page)
    lead = table.shape[:-2]
    flat = plan.rows.to(torch.int64) * table.shape[-1] + plan.lanes
    pre = table.reshape(*lead, -1).gather(-1, flat)
    delta = torch.where(
        # reprolint: allow[lanes] the commit's lane ids come from
        # table.swap_commit_lanes; only its WEAR charge saturates
        plan.lanes == table_lib.WEAR,
        torch.minimum(plan.delta, (table_lib.WEAR_CAP - pre).clamp_min(0)),
        plan.delta)
    out = table.clone()
    out.view(*lead, -1).scatter_add_(-1, flat, delta)
    return plan.dma, out, plan.done


def maybe_start(dma: DMAState, want: torch.Tensor, page_a: torch.Tensor,
                page_b: torch.Tensor, now: torch.Tensor,
                table: torch.Tensor | None = None
                ) -> tuple[DMAState, torch.Tensor]:
    """Start a new swap if the engine is idle, the policy wants one, and
    (when ``table`` is given) neither member is pinned or a retirement
    tombstone. Returns ``(state, started)``."""
    if table is not None:
        veto_bits = table_lib.PINNED | table_lib.RETIRED
        vetoed = ((take_lane(table, page_a, table_lib.FLAGS) |
                   take_lane(table, page_b, table_lib.FLAGS))
                  & veto_bits) != 0
        want = want & ~vetoed
    start_it = (dma.active == 0) & want
    return DMAState(
        active=torch.where(start_it, 1, dma.active).to(torch.int32),
        page_a=torch.where(start_it, page_a, dma.page_a).to(torch.int32),
        page_b=torch.where(start_it, page_b, dma.page_b).to(torch.int32),
        start=torch.where(start_it, now, dma.start).to(torch.int32),
        swaps_done=dma.swaps_done,
    ), start_it
