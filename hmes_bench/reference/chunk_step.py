"""The chunk step: the whole HMMU pipeline for one chunk of requests, in
plain PyTorch (a frozen copy of the emulator's plain "scan path", without
the CUDA kernel that the program launches).

:func:`step_batch` runs B design points at once along a leading point
axis, with closed-form max-plus scans, one row gather of every point's
chunk and DMA swap pair, and one combined boundary scatter for every
table write.

The chunk schedule (the ordering contract):

1. **Reads** — every table read of the chunk happens against the
   pre-chunk table: the stage-2 row gather (chunk pages + DMA swap pair)
   and the pre-values the commit needs.
2. **Boundary commit** — every table write lands in ONE flattened
   scatter-add of exact int32 deltas (hotness, demand-write WEAR, the
   swap commit, the OWNER update), then the decay shift and the
   min-wear scrub.
3. **Retire** — at most one dying frame's page is stamped POISONED.
4. **Policy** — the proposal reads the committed table, then
   ``dma.maybe_start`` and the CLOCK pointer commit; a pending rescue
   preempts the policy on the single DMA channel.

The step updates ``table`` **in place**.
"""
from __future__ import annotations

import functools
import inspect
from typing import NamedTuple

import torch

from . import consistency, dma as dma_lib
from . import faults as faults_lib
from . import gather as kernel_ops
from . import latency
from . import table as table_lib
from .config import FAST, SLOW, EmulatorConfig, RuntimeParams
from .indexing import put_lane_, scatter_add_drop_, take_lane, take_rows
from .policies import PolicyRegistry, _clock_victim, first_true, pick

_MIN = -(2 ** 31)
_NEG = -(2 ** 30)  # the invalid-slot arrival time


class StepScalars(NamedTuple):
    """The scalar slice of ``EmulatorState`` a chunk step carries (int32,
    one per point; the table and ``bank_free`` travel separately)."""
    clock: torch.Tensor
    clock_ptr: torch.Tensor
    chunk_idx: torch.Tensor
    dma: dma_lib.DMAState
    link_free_rx: torch.Tensor
    link_free_tx: torch.Tensor
    last_return: torch.Tensor
    rescue_page: torch.Tensor
    min_wear: torch.Tensor
    fault_cursor: torch.Tensor


class PipelineOut(NamedTuple):
    """Everything the pipeline phase hands the boundary phases (each with
    the leading point axis B)."""
    dev: torch.Tensor        # int32[chunk] — device actually accessed
    frm: torch.Tensor        # int32[chunk] — frame actually accessed
    row_a: torch.Tensor      # int32[W] — pre-chunk row of DMA member a
    row_b: torch.Tensor      # int32[W] — pre-chunk row of DMA member b
    returns: torch.Tensor    # int32[chunk] — TX return time (unmasked)
    lat: torch.Tensor        # int32[chunk] — request latency (masked)
    held: torch.Tensor       # int32 — responses delayed by tag matching
    poisoned: torch.Tensor   # bool[chunk] — touched a POISONED page
    bank_free: torch.Tensor  # int32[2*n_banks] — post-chunk bank busy times
    rx_last: torch.Tensor    # int32 — RX link busy-until after the chunk
    tx_last: torch.Tensor    # int32 — TX link busy-until after the chunk
    hot_pre: torch.Tensor    # int32[chunk] — pre-chunk HOTNESS of the pages


def _col(x: torch.Tensor) -> torch.Tensor:
    """A per-point scalar [B] as a column [B, 1] against a chunk [B, n]."""
    return x[..., None]


# --------------------------------------------------------------------------- #
# phase 1: the request pipeline (pure reads)
# --------------------------------------------------------------------------- #

def pipeline_phase(cfg: EmulatorConfig, params: RuntimeParams,
                   table: torch.Tensor, sc: StepScalars,
                   bank_free: torch.Tensor, page, offset, is_write, size,
                   valid) -> PipelineOut:
    """Stages 1-5 of the paper's Fig 2 workflow for every point: RX link,
    table lookup + DMA-conflict redirect, bank queues + media access,
    tag-match in-order return, TX link. Reads the table only."""
    n = page.shape[-1]
    size = torch.where(valid, size, 0)
    mp = latency.maxplus_scan

    # --- stage 1: RX link (host -> HMMU). Writes carry payload.
    step = torch.arange(1, n + 1, dtype=torch.int32, device=page.device)
    issue = torch.where(valid, _col(sc.clock) + _col(params.issue_gap) * step,
                        _NEG)
    rx_bytes = torch.where(is_write, size, 16)
    rx_srv = torch.where(valid, latency.link_service_cycles(params, rx_bytes),
                         0)
    rx_done = mp(torch.maximum(issue, torch.where(valid, _col(sc.link_free_rx),
                                                  _NEG)), rx_srv)
    half_link = _col(params.link_lat // 2)
    arrive = rx_done + torch.where(valid, half_link, 0)

    # --- stage 2: redirection-table lookup (+ DMA swap-progress redirect):
    # every point's chunk rows and swap pair in one gather.
    a = sc.dma.page_a.clamp_min(0)
    b = sc.dma.page_b.clamp_min(0)
    if cfg.fuse_swap_gather:
        rows, swap_rows = kernel_ops.hmmu_lookup_fused(
            table, page, sc.dma.page_a, sc.dma.page_b)
        row_a, row_b = swap_rows[..., 0, :], swap_rows[..., 1, :]
    else:
        rows = kernel_ops.hmmu_lookup(table, page.contiguous())
        row_a, row_b = take_rows(table, a), take_rows(table, b)
    dev = table_lib.device(rows)
    frm = table_lib.frame(rows)
    hot_pre = table_lib.hotness(rows)
    dev, frm = dma_lib.redirect(cfg, sc.dma, page, offset, arrive, dev, frm,
                                row_a, row_b, params)
    poisoned = valid & table_lib.is_poisoned(rows)

    # --- stage 3: per-device bank queues + media access.
    bank = dev * cfg.n_banks + frm % cfg.n_banks
    med_srv = torch.where(
        valid, latency.device_service_cycles(params, dev, is_write, size), 0)
    resolve = (latency.resolve_bank_queues_segmented
               if latency.pick_bank_resolver(cfg) == "segmented"
               else latency.resolve_bank_queues)
    med_done, bank_free2 = resolve(arrive, med_srv, bank, 2 * cfg.n_banks,
                                   bank_free)

    # --- stage 4: tag-match in-order return (paper §III-C) ...
    ordered = consistency.in_order_returns(torch.where(valid, med_done, _NEG),
                                           sc.last_return)
    held = ((ordered > med_done) & valid).sum(dim=-1, dtype=torch.int32)

    # --- stage 5: ... then TX link serialization.
    tx_bytes = torch.where(is_write, 16, size)
    tx_srv = torch.where(valid, latency.link_service_cycles(params, tx_bytes),
                         0)
    returns = mp(torch.maximum(ordered, torch.where(
        valid, _col(sc.link_free_tx), _NEG)), tx_srv) + \
        torch.where(valid, half_link, 0)
    lat = torch.where(valid, returns - issue, 0)
    return PipelineOut(dev, frm, row_a, row_b, returns, lat, held, poisoned,
                       bank_free2, rx_done[..., -1], returns[..., -1],
                       hot_pre)


# --------------------------------------------------------------------------- #
# phase 2: the boundary commit (ONE combined scatter-add, in place)
# --------------------------------------------------------------------------- #

def eff_write_weight(params: RuntimeParams,
                     registry: PolicyRegistry) -> torch.Tensor:
    """Policy-scoped hotness write weighting: only ``write_bias`` biases
    hotness by ``write_weight``. Keys on the raw ``policy_id``, so an id
    past the registry's end runs its clamped policy unweighted."""
    if "write_bias" in registry:
        return torch.where(params.policy_id == registry.index("write_bias"),
                           params.write_weight, 1)
    return torch.ones_like(params.write_weight)


def commit_phase(cfg: EmulatorConfig, params: RuntimeParams,
                 table: torch.Tensor, sc: StepScalars, pipe: PipelineOut,
                 page, is_write, valid, eff_weight):
    """Commit every point's chunk to its table in place: hotness
    accumulation, demand-write WEAR, the DMA swap commit and the OWNER
    update as exact int32 deltas in ONE scatter-add (saturating at the
    lane caps), then the decay shift and, on decay boundaries, the
    min-wear scrub.

    Returns ``(table, dma, done, now, last_ret, min_wear, tombstone)``.
    """
    n = page.shape[-1]
    w_lanes = table.shape[-1]
    n_pages = table.shape[-2]
    any_valid = valid.any(dim=-1)
    last_ret = torch.where(
        any_valid, torch.where(valid, pipe.returns,
                               _col(sc.last_return)).amax(dim=-1),
        sc.last_return)
    now = torch.maximum(sc.clock + params.issue_gap * n, last_ret)

    hot_w = 1 + _col(eff_weight - 1) * is_write.to(torch.int32)
    hot_w = torch.where(valid, hot_w, 0)
    hot_w = table_lib.saturating_weights(page, hot_w, pipe.hot_pre,
                                         table_lib.HOTNESS_CAP)
    slow_wr = is_write & valid & (pipe.dev == SLOW)

    swap_a = sc.dma.page_a.clamp_min(0)  # pre-completion swap pair
    plan = dma_lib.plan_commit(cfg, sc.dma, now, pipe.row_a, pipe.row_b,
                               params, sc.rescue_page)
    # OWNER inverse map: the promoted page owns its new fast frame; with
    # no swap completed the write goes to an out-of-range sentinel.
    db = table_lib.device(pipe.row_b)
    fb = table_lib.frame(pipe.row_b)
    promoted = plan.done & (db == FAST)
    own_pre = take_lane(table, fb, table_lib.OWNER)
    own_idx = torch.where(promoted, fb * w_lanes + table_lib.OWNER,
                          n_pages * w_lanes)
    own_delta = torch.where(promoted, swap_a - own_pre, 0)

    # WEAR: demand charges and the swap's migration charges saturate in
    # one fill-until-full pass against the pre-chunk WEAR.
    wear_mask = plan.lanes == table_lib.WEAR
    wear_rows = torch.cat([torch.where(slow_wr, pipe.frm, 0),
                           torch.where(wear_mask, plan.rows, 0)], dim=-1)
    wear_w = torch.cat([slow_wr.to(torch.int32),
                        torch.where(wear_mask, plan.delta, 0)], dim=-1)
    wear_pre = take_lane(table, wear_rows, table_lib.WEAR)
    wear_w = table_lib.saturating_weights(wear_rows, wear_w, wear_pre,
                                          table_lib.WEAR_CAP)
    plan_delta = torch.where(wear_mask, 0, plan.delta)

    idx = torch.cat([page * w_lanes + table_lib.HOTNESS,
                     wear_rows * w_lanes + table_lib.WEAR,
                     plan.rows * w_lanes + plan.lanes,
                     own_idx[..., None]], dim=-1)
    upd = torch.cat([hot_w, wear_w, plan_delta, own_delta[..., None]],
                    dim=-1)
    scatter_add_drop_(table.view(*table.shape[:-2], -1), idx, upd)

    do_decay = torch.remainder(sc.chunk_idx, params.decay_every) == \
        (params.decay_every - 1)
    hot = table[..., table_lib.HOTNESS]
    table[..., table_lib.HOTNESS] = torch.where(
        _col(do_decay), hot >> _col(params.hotness_decay_shift), hot)
    # Min-wear scrub: slow frames are rows [0, n_slow) of the WEAR lane.
    n_slow = n_pages - params.n_fast_pages
    rows_i = torch.arange(n_pages, dtype=torch.int32, device=table.device)
    wmin_global = torch.where(rows_i < _col(n_slow),
                              table[..., table_lib.WEAR], 2 ** 30).amin(dim=-1)
    min_wear = torch.where(do_decay, wmin_global, sc.min_wear)
    return table, plan.dma, plan.done, now, last_ret, min_wear, \
        plan.tombstone


# --------------------------------------------------------------------------- #
# phase 2.5: endurance-driven frame retirement (reads the committed table)
# --------------------------------------------------------------------------- #

def retire_phase(cfg: EmulatorConfig, params: RuntimeParams,
                 table: torch.Tensor, sc: StepScalars, rescue_page,
                 fault_cursor, faults: faults_lib.FaultPlan, page, valid):
    """Detect at most ONE frame death per point and boundary (a due
    FaultPlan death first, else an endurance crossing among the pages
    observed this boundary) and stamp its page POISONED with pins
    cleared, in place. Returns ``(table, rescue_page, fault_cursor,
    retired_page)``."""
    n_pages = table.shape[-2]
    dead_bits = table_lib.POISONED | table_lib.RETIRED
    free = rescue_page < 0

    nd = faults.deaths.shape[-2]
    ev = faults_lib.next_death(faults, fault_cursor)
    due = (fault_cursor < nd) & (ev[..., 0] <= sc.chunk_idx)
    consume = due & free
    ev_p = ev[..., 1].clamp(0, n_pages - 1)
    ev_flags = take_lane(table, ev_p, table_lib.FLAGS)
    death_fire = consume & ((ev_flags & dead_bits) == 0)
    fault_cursor = fault_cursor + consume.to(torch.int32)

    a, b = sc.dma.page_a, sc.dma.page_b
    cand = torch.cat([page, torch.stack([a.clamp_min(0), b.clamp_min(0)],
                                        dim=-1)], dim=-1)
    cand_ok = torch.cat([valid, torch.stack([a >= 0, b >= 0], dim=-1)],
                        dim=-1)
    cand = cand.clamp(0, n_pages - 1)
    rows = take_rows(table, cand)
    slow = table_lib.device(rows) == SLOW
    wear = take_lane(table, torch.where(slow, table_lib.frame(rows), 0),
                     table_lib.WEAR)
    budget = _col(params.endurance_budget)
    over = cand_ok & (budget > 0) & slow & (wear > budget) & \
        ((table_lib.flags(rows) & dead_bits) == 0)
    j = first_true(over)
    wear_fire = free & ~death_fire & pick(over, j)

    fire = death_fire | wear_fire
    p_ret = torch.where(death_fire, ev_p, pick(cand, j))
    old_fl = take_lane(table, p_ret, table_lib.FLAGS)
    new_fl = (old_fl | table_lib.POISONED) & ~table_lib.PINNED
    put_lane_(table, p_ret, table_lib.FLAGS, torch.where(fire, new_fl, old_fl))
    rescue_page = torch.where(fire, p_ret, rescue_page)
    return table, rescue_page, fault_cursor, torch.where(fire, p_ret, -1)


# --------------------------------------------------------------------------- #
# phase 3: the policy proposal (reads the committed table)
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _takes_min_wear(fn) -> bool:
    return "min_wear" in inspect.signature(fn).parameters


def _propose(cfg, params, registry, table, ptr, page, is_write, valid,
             min_wear):
    """Every point's proposal from the policy its ``policy_id`` selects,
    clamped into the registry as ``lax.switch`` clamps. Reading the ids
    present is one host synchronisation; each present policy runs over
    all points and each point keeps its own policy's proposal."""
    pid = params.policy_id.clamp(0, len(registry) - 1)
    out = None
    for k in sorted(set(pid.tolist())):
        fn = registry.fns[k]
        kw = {"min_wear": min_wear} if _takes_min_wear(fn) else {}
        prop = fn(cfg, params, table, ptr, page, is_write, valid, **kw)
        out = prop if out is None else tuple(
            torch.where(pid == k, x, y) for x, y in zip(prop, out))
    return out


def policy_phase(cfg: EmulatorConfig, params: RuntimeParams,
                 registry: PolicyRegistry, table: torch.Tensor,
                 sc: StepScalars, dma: dma_lib.DMAState, now, page, is_write,
                 valid, rescue_page, min_wear):
    """Run each point's policy (:func:`_propose`), mask its proposal
    (pins, device sanity), let a pending rescue preempt it, start the DMA
    engine and commit the CLOCK pointer. Returns ``(dma, clock_ptr)``."""
    n_pages = table.shape[-2]
    any_valid = valid.any(dim=-1)
    p_want, cand, victim, new_ptr = _propose(
        cfg, params, registry, table, sc.clock_ptr, page, is_write, valid,
        min_wear)
    cand_row, victim_row = take_rows(table, cand), take_rows(table, victim)
    unpinned = ~(table_lib.is_pinned(cand_row) |
                 table_lib.is_pinned(victim_row))
    want = p_want & any_valid & unpinned & \
        (table_lib.device(cand_row) == SLOW) & \
        (table_lib.device(victim_row) == FAST)

    # Rescue migration override (no effect while the register is idle).
    pending = rescue_page >= 0
    resc = rescue_page.clamp(0, n_pages - 1)
    r_slow = table_lib.device(take_rows(table, resc)) == SLOW
    r_victim, r_found, r_skip = _clock_victim(table, sc.clock_ptr,
                                              params.n_fast_pages)
    pg = page.clamp(0, n_pages - 1)
    rows_pg = take_rows(table, pg)
    donor_ok = valid & (table_lib.device(rows_pg) == SLOW) & \
        ((table_lib.flags(rows_pg) &
          (table_lib.PINNED | table_lib.RETIRED | table_lib.POISONED)) == 0)
    dj = first_true(donor_ok)
    r_want = pending & torch.where(r_slow, r_found, pick(donor_ok, dj))
    final_want = torch.where(pending, r_want, want)
    page_a = torch.where(pending, torch.where(r_slow, resc, pick(pg, dj)),
                         cand)
    page_b = torch.where(pending, torch.where(r_slow, r_victim, resc),
                         victim)

    dma, started = dma_lib.maybe_start(dma, final_want, page_a, page_b, now,
                                       table)
    ptr_rescue = (sc.clock_ptr + r_skip + 1) % params.n_fast_pages
    clock_ptr = torch.where(
        pending,
        torch.where(r_slow & started, ptr_rescue, sc.clock_ptr),
        torch.where(started | ~p_want, new_ptr, sc.clock_ptr))
    return dma, clock_ptr.to(torch.int32)


# --------------------------------------------------------------------------- #
# the whole step
# --------------------------------------------------------------------------- #

def step_batch(cfg: EmulatorConfig, registry: PolicyRegistry,
               table: torch.Tensor, params: RuntimeParams, sc: StepScalars,
               bank_free: torch.Tensor, page, offset, is_write, size, valid,
               faults: faults_lib.FaultPlan | None = None):
    """One chunk end to end (reads -> commit -> retire -> policy) for B
    design points at once, each point's table updated in place.

    Returns ``(table, scalars, bank_free, outs)`` with ``outs`` carrying
    ``returns`` (masked), ``device`` (raw post-redirect), ``latency``
    (masked), the ``held``/``poisoned``/``injected`` counter inputs and
    the boundary's ``retired``/``tombstone`` pages (-1 when none), each
    with the point axis.
    """
    if faults is None:
        faults = faults_lib.FaultPlan.empty(device=table.device)
    pipe = pipeline_phase(cfg, params, table, sc, bank_free,
                          page, offset, is_write, size, valid)
    injected = faults_lib.injected(faults, page, sc.chunk_idx) & valid
    table, dma, done, now, last_ret, min_wear, tombstone = commit_phase(
        cfg, params, table, sc, pipe, page, is_write, valid,
        eff_write_weight(params, registry))
    rescue_page = torch.where(done & (tombstone >= 0), -1, sc.rescue_page)
    table, rescue_page, fault_cursor, retired = retire_phase(
        cfg, params, table, sc, rescue_page, sc.fault_cursor, faults, page,
        valid)
    dma, clock_ptr = policy_phase(cfg, params, registry, table, sc, dma, now,
                                  page, is_write, valid, rescue_page,
                                  min_wear)
    any_valid = valid.any(dim=-1)
    sc2 = StepScalars(
        clock=now, clock_ptr=clock_ptr, chunk_idx=sc.chunk_idx + 1, dma=dma,
        link_free_rx=torch.where(any_valid, pipe.rx_last, sc.link_free_rx),
        link_free_tx=torch.where(any_valid, pipe.tx_last, sc.link_free_tx),
        last_return=last_ret, rescue_page=rescue_page, min_wear=min_wear,
        fault_cursor=fault_cursor)
    outs = {"returns": torch.where(valid, pipe.returns, 0),
            "device": pipe.dev, "latency": pipe.lat,
            "held": pipe.held, "poisoned": pipe.poisoned,
            "injected": injected, "retired": retired,
            "tombstone": tombstone}
    return table, sc2, pipe.bank_free, outs


