"""The chunk step: the whole HMMU pipeline for one chunk of requests.

Written once in PyTorch and executed three ways:

* :func:`step_batch` — the "scan path" for B design points at once (the
  JAX package's ``vmap`` written out as a leading point axis): closed-form
  max-plus scans (``core.latency``), the stage-2 row gather of every
  point's chunk and DMA swap pair in ONE call of
  ``kernels.ops.hmmu_lookup_fused`` (one launch of the CUDA gather kernel
  for CUDA tensors), one combined boundary scatter for every table write;
  :func:`step_ref` is the same step for one point (a point axis of one);
* ``step_ref(..., seq=True)`` — the same step with the sequential
  recurrences run as host loops: the plain version the CUDA kernel is
  held against;
* the CUDA kernel ``csrc/chunk_step.cu`` (:func:`chunk_step_cuda`), which
  replaces the TPU kernel ``repro/kernels/chunk_step.py::_pallas_step_fn``
  (its ``pallas_call`` at line 793) and the chunk loop around it: one
  launch runs every chunk of a trace, counters included, with one
  thread-block cluster per design point and the table in global memory.
  :func:`chunk_step` launches it for one chunk.

All three are bitwise equal to the JAX package's ``step_ref``: the
pipeline arithmetic is exact int32 and the float32 cycle math is one IEEE
division and a ceil.

Shapes on the point axis: the table [B, n_pages, 8], every params field
and step scalar [B], ``bank_free`` [B, 2*n_banks], the request vectors
[B, chunk] (a chunk shared by every point may be an expanded view), the
fault plan shared ([nt, 2], [nd, 2]) or stacked ([B, nt, 2], ...).

The chunk schedule (the ordering contract every form keeps):

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

The step updates ``table`` **in place** (where the JAX package donated
it): callers that need the pre-step table keep a clone.
"""
from __future__ import annotations

import ctypes
import functools
import inspect
from typing import NamedTuple

import torch

from ..core import consistency, counters as counters_lib, dma as dma_lib
from ..core import latency
from ..core import faults as faults_lib
from ..core import table as table_lib
from ..core.config import (FAST, FLOAT_PARAM_FIELDS, SLOW, EmulatorConfig,
                           RuntimeParams)
from ..core.indexing import (index_points, put_lane_, scatter_add_drop_,
                             take_lane, take_rows)
from ..core.policies import PolicyRegistry, _clock_victim, first_true, pick
from . import ops as kernel_ops
from .build import INT, PTR, CudaKernel

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
# sequential formulations of the ordering-sensitive stages (host loops)
# --------------------------------------------------------------------------- #

def _wrap32(x: int) -> int:
    """Python int -> the int32 value two's-complement arithmetic gives."""
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _seq_maxplus(arrival: torch.Tensor, service: torch.Tensor) -> torch.Tensor:
    """``done_i = max(arrival_i, done_{i-1}) + service_i`` as a loop."""
    prev, out = _MIN, []
    for a, s in zip(arrival.tolist(), service.tolist()):
        prev = _wrap32(max(a, prev) + s)
        out.append(prev)
    return torch.tensor(out, dtype=torch.int32, device=arrival.device)


def _seq_bank_resolve(arrival, service, bank, bank_free):
    """One pass over the chunk with a live ``bank_free`` register file
    (gather rule on the read, drop rule on the write, as in JAX)."""
    free = bank_free.tolist()
    nb = len(free)
    done = []
    for a, s, b in zip(arrival.clamp_min(_NEG).tolist(), service.tolist(),
                       bank.tolist()):
        w = b + nb if b < 0 else b
        d = _wrap32(max(a, free[min(max(w, 0), nb - 1)]) + s)
        if 0 <= w < nb:
            free[w] = d
        done.append(d)
    dev = arrival.device
    return (torch.tensor(done, dtype=torch.int32, device=dev),
            torch.tensor(free, dtype=torch.int32, device=dev))


def _seq_inorder(complete: torch.Tensor,
                 last_return: torch.Tensor) -> torch.Tensor:
    """Running max over ``max(complete_i, last_return)`` as a loop."""
    lr, run, out = int(last_return), _MIN, []
    for c in complete.tolist():
        run = max(c, lr, run)
        out.append(run)
    return torch.tensor(out, dtype=torch.int32, device=complete.device)


def _each_point(fn):
    """A one-point host loop ``fn`` run on every point of a leading axis,
    its results stacked."""
    def run(*xs):
        outs = [fn(*x) for x in zip(*xs)]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o) for o in zip(*outs))
        return torch.stack(outs)
    return run


# --------------------------------------------------------------------------- #
# phase 1: the request pipeline (pure reads)
# --------------------------------------------------------------------------- #

def pipeline_phase(cfg: EmulatorConfig, params: RuntimeParams,
                   table: torch.Tensor, sc: StepScalars,
                   bank_free: torch.Tensor, page, offset, is_write, size,
                   valid, *, seq: bool = False) -> PipelineOut:
    """Stages 1-5 of the paper's Fig 2 workflow for every point: RX link,
    table lookup + DMA-conflict redirect, bank queues + media access,
    tag-match in-order return, TX link. Reads the table only."""
    n = page.shape[-1]
    n_pages = table.shape[-2]
    size = torch.where(valid, size, 0)
    mp = _each_point(_seq_maxplus) if seq else latency.maxplus_scan

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
    if seq:
        rows = take_rows(table, page.clamp(0, n_pages - 1))
        row_a, row_b = take_rows(table, a), take_rows(table, b)
    elif cfg.fuse_swap_gather:
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
    if seq:
        med_done, bank_free2 = _each_point(_seq_bank_resolve)(
            arrive, med_srv, bank, bank_free)
    else:
        resolve = (latency.resolve_bank_queues_segmented
                   if latency.pick_bank_resolver(cfg) == "segmented"
                   else latency.resolve_bank_queues)
        med_done, bank_free2 = resolve(arrive, med_srv, bank,
                                       2 * cfg.n_banks, bank_free)

    # --- stage 4: tag-match in-order return (paper §III-C) ...
    inorder = _each_point(_seq_inorder) if seq \
        else consistency.in_order_returns
    ordered = inorder(torch.where(valid, med_done, _NEG), sc.last_return)
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
               faults: faults_lib.FaultPlan | None = None, *,
               seq: bool = False):
    """One chunk end to end (reads -> commit -> retire -> policy) for B
    design points at once (shapes in the module docstring), each point's
    table updated in place. ``seq=True`` runs the sequential recurrences
    (one point after another) and a plain row gather: the plain version
    of the CUDA chunk-step kernel.

    Returns ``(table, scalars, bank_free, outs)`` with ``outs`` carrying
    ``returns`` (masked), ``device`` (raw post-redirect), ``latency``
    (masked), the ``held``/``poisoned``/``injected`` counter inputs and
    the boundary's ``retired``/``tombstone`` pages (-1 when none), each
    with the point axis.
    """
    if faults is None:
        faults = faults_lib.FaultPlan.empty(device=table.device)
    pipe = pipeline_phase(cfg, params, table, sc, bank_free,
                          page, offset, is_write, size, valid, seq=seq)
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


def step_ref(cfg: EmulatorConfig, registry: PolicyRegistry,
             table: torch.Tensor, params: RuntimeParams, sc: StepScalars,
             bank_free: torch.Tensor, page, offset, is_write, size, valid,
             faults: faults_lib.FaultPlan | None = None, *,
             seq: bool = False):
    """:func:`step_batch` for one design point (a point axis of one): the
    table [n_pages, 8], 0-dim params and scalars, request vectors [chunk],
    one fault plan; ``table`` updated in place. Returns as
    :func:`step_batch`, without the point axis."""
    one = functools.partial(index_points, i=None)
    _, sc2, bank_free2, outs = step_batch(
        cfg, registry, table[None], one(params), one(sc), bank_free[None],
        *(x[None] for x in (page, offset, is_write, size, valid)), faults,
        seq=seq)
    return (table, index_points(sc2, 0), bank_free2[0],
            {k: v[0] for k, v in outs.items()})


# --------------------------------------------------------------------------- #
# the CUDA kernel
# --------------------------------------------------------------------------- #

# Scalar-state slots at the head of the int vector (before the int
# params, in RuntimeParams field order); csrc/chunk_step.cu's IntSlot enum
# names the same slots in the same order.
SC_FIELDS = ("clock", "clock_ptr", "chunk_idx", "dma_active", "dma_page_a",
             "dma_page_b", "dma_start", "dma_swaps_done", "link_free_rx",
             "link_free_tx", "last_return", "rescue_page", "min_wear",
             "fault_cursor")
INT_PARAM_FIELDS = tuple(f for f in RuntimeParams._fields
                         if f not in FLOAT_PARAM_FIELDS)
FLOAT_PARAM_ORDER = tuple(f for f in RuntimeParams._fields
                          if f in FLOAT_PARAM_FIELDS)
# The counters the kernel carries, int32 and float32 apart, each in
# Counters field order (the .cu's CounterInt and CounterFloat enums).
COUNTER_INT_FIELDS = tuple(f for f in counters_lib.Counters._fields
                           if f not in counters_lib.FLOAT_FIELDS)
COUNTER_FLOAT_FIELDS = tuple(f for f in counters_lib.Counters._fields
                             if f in counters_lib.FLOAT_FIELDS)
# What the kernel reports per chunk (the .cu's ChunkOut enum).
CHUNK_OUT = ("held", "retired", "tombstone")
# The kernel's clock64() split of a chunk (the .cu's Phase enum), made
# only by the stamped build, KERNEL_STAMPED.
PHASES = ("load", "rx", "redirect", "stage345", "commit", "satw", "decay",
          "retire", "policy")
# CTAs per design point: the leader runs the chunk loop, all of them share
# the whole-table passes (decay, hotness_global).
CLUSTER = 8

_I32 = torch.int32

# Where a launch keeps the per-request arrays of a chunk: the block's
# shared memory, or (a chunk too wide for it) a global workspace the
# wrapper allocates. ``KERNEL.variant_launches`` counts the launches of
# each; :func:`chunk_layout` says which a chunk takes.
LAYOUTS = ("shared", "workspace")
_ENTRIES = {"chunk_step_layout": (INT, INT, ctypes.POINTER(ctypes.c_longlong))}

KERNEL = CudaKernel(
    "chunk_step", "chunk_step_launch",
    (PTR,) * 26 + (INT,) * 13, variants=LAYOUTS, entries=_ENTRIES)
# The same source with clock64() stamps per phase: measurement only.
KERNEL_STAMPED = CudaKernel(
    "chunk_step", "chunk_step_launch", KERNEL.argtypes, variants=LAYOUTS,
    defines=("-DREPRO_PHASE_STAMPS",), entries=_ENTRIES)


class WorkspaceError(RuntimeError):
    """Kernel B cannot run this chunk: its workspace would not fit int32
    indices, or the card could not allocate it."""


def chunk_words(chunk: int, n_banks: int) -> int:
    """int32 words of a chunk's per-request arrays, bank registers and
    sort counts, a design point (the .cu's ``smem_words``)."""
    return (15 * chunk + 5 * (chunk + 10)
            + 2 * n_banks * (1 + (chunk + 31) // 32))


@functools.lru_cache(maxsize=None)
def chunk_layout(device: str, chunk: int, n_banks: int) -> tuple[str, int]:
    """(layout, words): where kernel B keeps a chunk's per-request arrays
    on ``device`` — ``"shared"`` when they fit in a block's opt-in shared
    memory there, else ``"workspace"`` — and how many int32 words
    (:func:`chunk_words`) they take a design point. Raises
    :class:`WorkspaceError` where those words pass int32 indices."""
    words = chunk_words(chunk, n_banks)
    if chunk <= 0 or words >= 2 ** 31:
        raise WorkspaceError(
            f"chunk {chunk} at {n_banks} banks needs {words} int32 words a "
            "design point: outside kernel B's int32 indices")
    c_words = ctypes.c_longlong(0)
    which = KERNEL.query(torch.device(device), "chunk_step_layout", chunk,
                         n_banks, ctypes.byref(c_words))
    if c_words.value != words:
        raise RuntimeError(f"kernel B sizes chunk {chunk} at "
                           f"{c_words.value} words, the wrapper at {words}")
    return LAYOUTS[which], words


class KernelOut(NamedTuple):
    """What one launch returns, per design point (leading axis B)."""
    scalars: torch.Tensor         # int32[B, 14] — state after the last chunk
    bank_free: torch.Tensor       # int32[B, 2*n_banks]
    chunks: torch.Tensor          # int32[B, n_chunks, 3] — CHUNK_OUT
    returns: torch.Tensor         # int32[B, N] — TX return time (masked)
    device: torch.Tensor          # int32[B, N] — post-redirect device (raw)
    latency: torch.Tensor         # int32[B, N] — request latency (masked)
    poisoned: torch.Tensor        # int32[B, N] — 0/1
    injected: torch.Tensor        # int32[B, N] — 0/1
    counters_int: torch.Tensor    # int32[B, 10] — COUNTER_INT_FIELDS
    counters_float: torch.Tensor  # float32[B, 6] — COUNTER_FLOAT_FIELDS


def scalar_tensors(sc: StepScalars) -> list:
    """The 0-dim tensors of ``sc`` in SC_FIELDS order."""
    d = sc.dma
    return [sc.clock, sc.clock_ptr, sc.chunk_idx, d.active, d.page_a,
            d.page_b, d.start, d.swaps_done, sc.link_free_rx,
            sc.link_free_tx, sc.last_return, sc.rescue_page, sc.min_wear,
            sc.fault_cursor]


def _pack_scalars(params: RuntimeParams, sc: StepScalars):
    """(int32[..., 14 + 15], float32[..., 7]): the state scalars and int
    params, and the float params; ``...`` is the point axis of stacked
    params and scalars (none for one point)."""
    ints = scalar_tensors(sc) + [getattr(params, f) for f in INT_PARAM_FIELDS]
    floats = [getattr(params, f) for f in FLOAT_PARAM_ORDER]
    return (torch.stack([v.to(_I32) for v in ints], dim=-1),
            torch.stack([v.to(torch.float32) for v in floats], dim=-1))


def pack_counters(c: counters_lib.Counters):
    """(int32[..., 10], float32[..., 6]): the counters in the kernel's
    order (``...`` as in :func:`_pack_scalars`)."""
    return (torch.stack([getattr(c, f) for f in COUNTER_INT_FIELDS], dim=-1),
            torch.stack([getattr(c, f) for f in COUNTER_FLOAT_FIELDS],
                        dim=-1))


def _unpack_out_scalars(scv: torch.Tensor) -> StepScalars:
    """The kernel's int32[..., 14] state -> StepScalars of views (0-dim
    for one point, [B] for a point axis)."""
    s = scv.unbind(-1)
    return StepScalars(
        clock=s[0], clock_ptr=s[1], chunk_idx=s[2],
        dma=dma_lib.DMAState(active=s[3], page_a=s[4], page_b=s[5],
                             start=s[6], swaps_done=s[7]),
        link_free_rx=s[8], link_free_tx=s[9], last_return=s[10],
        rescue_page=s[11], min_wear=s[12], fault_cursor=s[13])


@functools.lru_cache(maxsize=None)
def _registry_map(builtin_ids: tuple, device: str) -> torch.Tensor:
    return torch.tensor(builtin_ids, dtype=_I32, device=device)


def chunk_step_cuda(cfg: EmulatorConfig, registry: PolicyRegistry,
                    table, ints, floats, bank_free, page, offset, is_write,
                    size, valid, transient, deaths, counters_int,
                    counters_float, *, phases=None,
                    cluster: int = CLUSTER) -> KernelOut:
    """Run ``N // cfg.chunk`` chunks on B design points in ONE launch (a
    cluster of ``cluster`` thread blocks each). Updates ``table``
    int32[B, n_pages, 8] in place.

    Inputs: ``ints`` int32[B, 29] and ``floats`` float32[B, 7] from
    :func:`_pack_scalars`; ``bank_free`` int32[B, 2*n_banks]; the five
    request vectors int32[B, N], N a multiple of the chunk
    (``is_write``/``valid`` as 0/1); ``transient`` int32[B, nt, 2] and
    ``deaths`` int32[B, nd, 2]; the counters from :func:`pack_counters`,
    int32[B, 10] and float32[B, 6]. ``phases``, when given, is an
    int64[B, 9] to which the leading block's thread 0 adds the cycles of
    each of PHASES: the launch then goes to :data:`KERNEL_STAMPED`.

    A chunk whose per-request arrays do not fit in a block's shared
    memory (:func:`chunk_layout`) runs on a workspace int32[B, words]
    that this call allocates; :class:`WorkspaceError` when it cannot.
    """
    dev = table.device
    if not table.is_cuda:
        raise ValueError("chunk_step_cuda needs CUDA tensors")
    if table.dim() != 3 or table.shape[-1] != table_lib.ROW_W:
        raise ValueError(f"table must be [B, n_pages, {table_lib.ROW_W}]")
    b, n_pages, _ = table.shape
    chunk, nb = cfg.chunk, 2 * cfg.n_banks
    n = page.shape[-1]
    if n == 0 or n % chunk:
        raise ValueError(f"the request vectors must hold a positive "
                         f"multiple of the chunk ({chunk}), got {n}")
    nt, nd = transient.shape[1], deaths.shape[1]
    shapes = {"ints": (ints, (b, len(SC_FIELDS) + len(INT_PARAM_FIELDS))),
              "floats": (floats, (b, len(FLOAT_PARAM_ORDER))),
              "bank_free": (bank_free, (b, nb)), "page": (page, (b, n)),
              "offset": (offset, (b, n)), "is_write": (is_write, (b, n)),
              "size": (size, (b, n)), "valid": (valid, (b, n)),
              "transient": (transient, (b, nt, 2)),
              "deaths": (deaths, (b, nd, 2)),
              "counters_int": (counters_int, (b, len(COUNTER_INT_FIELDS))),
              "counters_float": (counters_float,
                                 (b, len(COUNTER_FLOAT_FIELDS)))}
    if phases is not None:
        shapes["phases"] = (phases, (b, len(PHASES)))
    for name, (t, shape) in [("table", (table, (b, n_pages, 8))),
                             *shapes.items()]:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, table on {dev}")
        want = {"floats": torch.float32, "counters_float": torch.float32,
                "phases": torch.int64}.get(name, _I32)
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_pages * table_lib.ROW_W >= 2 ** 31:
        raise ValueError("table too large for int32 flat indices")
    layout, words = chunk_layout(str(dev), chunk, cfg.n_banks)
    workspace = None
    if layout == "workspace":
        try:
            workspace = torch.empty(b, words, dtype=_I32, device=dev)
        except torch.cuda.OutOfMemoryError as e:
            raise WorkspaceError(
                f"kernel B's workspace for chunk {chunk} at {b} points "
                f"({b * words * 4} B) could not be allocated") from e
    wb = registry.index("write_bias") if "write_bias" in registry else -1
    reg = _registry_map(registry.builtin_ids, str(dev))

    def out(*shape, dtype=_I32):
        return torch.empty(*shape, dtype=dtype, device=dev)

    res = KernelOut(
        out(b, len(SC_FIELDS)), out(b, nb), out(b, n // chunk, len(CHUNK_OUT)),
        *(out(b, n) for _ in range(5)), out(b, len(COUNTER_INT_FIELDS)),
        out(b, len(COUNTER_FLOAT_FIELDS), dtype=torch.float32))
    (KERNEL if phases is None else KERNEL_STAMPED).launch(
        dev,
        table.data_ptr(), page.data_ptr(), offset.data_ptr(),
        is_write.data_ptr(), size.data_ptr(), valid.data_ptr(),
        ints.data_ptr(), floats.data_ptr(), bank_free.data_ptr(),
        transient.data_ptr(), deaths.data_ptr(), reg.data_ptr(),
        counters_int.data_ptr(), counters_float.data_ptr(),
        *(t.data_ptr() for t in res),
        0 if workspace is None else workspace.data_ptr(),
        0 if phases is None else phases.data_ptr(),
        b, cluster, n_pages, chunk, n // chunk, cfg.n_banks, nt, nd,
        len(registry), wb, cfg.subblock, cfg.subblocks_per_page,
        cfg.page_size // cfg.line_size)
    return res


def use_chunk_step_kernel(cfg: EmulatorConfig, table: torch.Tensor) -> bool:
    """Resolve the ``chunk_step_kernel`` knob for ``table``'s device:
    "auto" is the kernel exactly for CUDA tensors, "on" requires a CUDA
    tensor (raises otherwise), "off" is the scan path everywhere."""
    knob = cfg.chunk_step_kernel
    if knob == "off":
        return False
    if knob == "on":
        if not table.is_cuda:
            raise ValueError('chunk_step_kernel="on" needs CUDA tensors: the '
                             "chunk-step kernel exists only as CUDA")
        return True
    if knob != "auto":
        raise ValueError(f"unknown chunk_step_kernel {knob!r}; expected "
                         "'auto', 'on' or 'off'")
    return table.is_cuda


def refuse_user_policies(cfg: EmulatorConfig, registry: PolicyRegistry,
                         params: RuntimeParams, selected=None) -> None:
    """Raise where the chunk-step kernel would run a point whose policy
    is not built-in: the kernel compiles the six built-ins in, and a
    registry entry is built-in by the identity of its function, never by
    its name. ``selected`` holds the registry indices the dispatch runs,
    where the host knows them (the engine's default point, a sweep's
    points); otherwise, and only when the registry holds a user policy,
    the clamped ``params.policy_id`` is read once. Never changes route."""
    if not registry.user_policies():
        return
    if selected is None:
        selected = params.policy_id.clamp(0, len(registry) - 1).reshape(
            -1).unique().tolist()
    users = registry.user_policies(selected)
    if users:
        raise ValueError(
            f"policy {', '.join(map(repr, users))} is a user policy: the "
            f"chunk-step kernel (chunk_step_kernel={cfg.chunk_step_kernel!r} "
            "on a CUDA device) runs only the six built-in policies. "
            'chunk_step_kernel="off" runs user policies on the card, with '
            "the lookup kernel gathering the rows")


def chunk_step(cfg: EmulatorConfig, registry: PolicyRegistry,
               table: torch.Tensor, params: RuntimeParams, sc: StepScalars,
               bank_free: torch.Tensor, page, offset, is_write, size, valid,
               faults: faults_lib.FaultPlan | None = None):
    """THE chunk step — the CUDA kernel (a launch of one chunk) or the
    scan path, resolved by :func:`use_chunk_step_kernel` (bitwise equal
    either way). Signature and returns as :func:`step_ref`; ``table`` is
    updated in place."""
    if faults is None:
        faults = faults_lib.FaultPlan.empty(device=table.device)
    if not use_chunk_step_kernel(cfg, table):
        return step_ref(cfg, registry, table, params, sc, bank_free,
                        page, offset, is_write, size, valid, faults)
    refuse_user_policies(cfg, registry, params)
    ints, floats = _pack_scalars(params, sc)
    out = chunk_step_cuda(
        cfg, registry, table[None], ints[None], floats[None],
        bank_free[None], page[None], offset[None],
        is_write.to(_I32)[None], size[None], valid.to(_I32)[None],
        faults.transient[None], faults.deaths[None],
        torch.zeros(1, len(COUNTER_INT_FIELDS), dtype=_I32,
                    device=table.device),
        torch.zeros(1, len(COUNTER_FLOAT_FIELDS), dtype=torch.float32,
                    device=table.device))
    held, retired, tombstone = out.chunks[0, 0]
    outs = {"returns": out.returns[0], "device": out.device[0],
            "latency": out.latency[0], "held": held,
            "poisoned": out.poisoned[0] != 0,
            "injected": out.injected[0] != 0, "retired": retired,
            "tombstone": tombstone}
    return table, _unpack_out_scalars(out.scalars[0]), out.bank_free[0], outs
