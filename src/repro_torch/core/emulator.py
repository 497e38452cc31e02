"""The HMMU emulation pipeline (PyTorch port of ``repro.core.emulator``).

Requests flow through the paper's Fig 2 stages (RX link -> table lookup
-> DMA-conflict redirect -> bank queues -> media -> tag-match in-order
return -> TX link) one chunk at a time in ``kernels.chunk_step``. On a
CUDA tensor with the chunk-step kernel selected, ONE launch runs every
chunk of the trace and folds the counters (the JAX package's
``lax.scan``); otherwise this module loops the step over the chunks and
folds each chunk's results into the counters. Either way a sweep's B
design points run together: on the loop, each chunk is one
``step_batch`` over all of them (the JAX package's ``vmap``, written out
as a leading point axis). Drive it through :class:`repro_torch.Engine`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import counters as counters_lib, dma as dma_lib, table as table_lib
from .. import telemetry
from .config import EmulatorConfig, RuntimeParams, static_key
from .faults import FaultPlan
from .indexing import index_points as _index
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
    with telemetry.span("emulator.init_state"):
        if params is not None:
            device = params.n_fast_pages.device
        nf = None if params is None else params.n_fast_pages
        pin = None if params is None else params.pin_fast_fraction
        return EmulatorState(table=table_lib.init_table(cfg, nf, pin,
                                                        device=device),
                             **_fresh_fields(cfg, device))


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


def clone_state(state: EmulatorState) -> EmulatorState:
    """A deep copy of ``state`` (every tensor cloned)."""
    def c(x):
        return type(x)(*(c(y) for y in x)) if isinstance(x, tuple) \
            else x.clone()
    return c(state)


def pad_trace(cfg: EmulatorConfig, t: Trace) -> tuple[Trace, torch.Tensor]:
    """Pad to a multiple of cfg.chunk; returns (trace, valid mask)."""
    with telemetry.span("emulator.pad_trace"):
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
                seq: bool):
    """One chunk of B design points (stacked ``state`` and ``params``,
    request vectors and ``valid`` [B, chunk]) through ``step_batch``
    (with the sequential recurrences when ``seq``), then the counter
    update."""
    page, offset, is_write, size = trace
    size = torch.where(valid, size, 0)
    table, sc, bank_free, outs = chunk_step_lib.step_batch(
        cfg, registry, state.table, params, _step_scalars(state),
        state.bank_free, page, offset, is_write, size, valid, faults,
        seq=seq)
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
    shape = page.shape
    out = {"returns": outs["returns"],
           "device": torch.where(valid, outs["device"], -1),
           "latency": outs["latency"],
           "faulted": (outs["poisoned"] | outs["injected"]) & valid,
           "retired_page": outs["retired"][..., None].expand(shape),
           "tombstone": outs["tombstone"][..., None].expand(shape)}
    return new_state, out


def _chunk_loop(cfg: EmulatorConfig, registry: PolicyRegistry, trace: Trace,
                valid: torch.Tensor, states: EmulatorState,
                params: RuntimeParams, faults: FaultPlan, seq: bool
                ) -> tuple[EmulatorState, dict]:
    """The plain chunk loop over B stacked design points: ONE
    ``step_batch`` a chunk for all of them. ``trace`` is [N], shared by
    every point and broadcast as an expanded view (never copied a
    point), or [B, N]; ``valid`` is [N]. Returns the final states (the
    passed table updated in place) and the [B, N] outputs."""
    with telemetry.span("emulator.chunk_loop"):
        b = states.table.shape[0]
        trace = Trace(*(x.expand(b, -1) for x in trace))
        valid = valid.expand(b, -1)
        new, parts = states, []
        for lo in range(0, len(trace), cfg.chunk):
            sl = slice(lo, lo + cfg.chunk)
            new, out = _chunk_step(cfg, params, registry, faults, new,
                                   Trace(*(x[:, sl] for x in trace)),
                                   valid[:, sl], seq)
            parts.append(out)
        return new, {k: torch.cat([p[k] for p in parts], dim=-1)
                     for k in parts[0]}


def _tensors(x) -> list:
    return [y for v in x for y in _tensors(v)] if isinstance(x, tuple) \
        else [x]


def _write_back(state: EmulatorState, new: EmulatorState) -> EmulatorState:
    """Copy ``new`` into ``state``'s own tensors; returns ``state``. Both
    routes of :func:`_emulate_impl` end here, so a passed state is
    updated in place wherever the run went."""
    for dst, src in zip(_tensors(state), _tensors(new), strict=True):
        # A run at a point axis of one updated a view of ``state``'s own
        # table in place: that is the same memory, with nothing to copy.
        same = dst is src or (dst.data_ptr() == src.data_ptr() and
                              dst.stride() == src.stride())
        if not same:
            dst.copy_(src)
    return state


def kernel_counters(out: chunk_step_lib.KernelOut, b=0
                    ) -> counters_lib.Counters:
    """Design point ``b``'s counters from a chunk-step launch (views);
    ``b=ALL`` gives every point's, stacked."""
    cs = chunk_step_lib
    vals = dict(zip(cs.COUNTER_INT_FIELDS, out.counters_int[b].unbind(-1)))
    vals.update(zip(cs.COUNTER_FLOAT_FIELDS,
                    out.counters_float[b].unbind(-1)))
    return counters_lib.Counters(**vals)


# The ``b`` of :func:`kernel_state` / :func:`kernel_outs` that selects
# every design point of a launch, stacked along a leading axis.
ALL = slice(None)


def kernel_state(table: torch.Tensor, out: chunk_step_lib.KernelOut,
                 b=0) -> EmulatorState:
    """Design point ``b``'s final state from a chunk-step launch that
    updated ``table`` (views of ``out``); with ``b=ALL``, ``table`` is the
    launch's [B, n_pages, 8] table and the state is stacked."""
    sc = chunk_step_lib._unpack_out_scalars(out.scalars[b])
    return EmulatorState(
        table=table, clock_ptr=sc.clock_ptr, chunk_idx=sc.chunk_idx,
        dma=sc.dma, clock=sc.clock, bank_free=out.bank_free[b],
        link_free_rx=sc.link_free_rx, link_free_tx=sc.link_free_tx,
        last_return=sc.last_return, counters=kernel_counters(out, b),
        rescue_page=sc.rescue_page, min_wear=sc.min_wear,
        fault_cursor=sc.fault_cursor)


def kernel_outs(cfg: EmulatorConfig, out: chunk_step_lib.KernelOut,
                valid: torch.Tensor, b=0) -> dict:
    """Design point ``b``'s per-request outputs from a chunk-step launch,
    as :func:`_emulate_impl` returns them (per-chunk values expanded);
    with ``b=ALL`` every point's, [B, N] each."""
    def per_request(name):
        k = chunk_step_lib.CHUNK_OUT.index(name)
        return out.chunks[b][..., k].repeat_interleave(cfg.chunk, dim=-1)
    return {"returns": out.returns[b],
            "device": torch.where(valid, out.device[b], -1),
            "latency": out.latency[b],
            "faulted": (out.poisoned[b] | out.injected[b]) != 0,
            "retired_page": per_request("retired"),
            "tombstone": per_request("tombstone")}


def _launch(cfg: EmulatorConfig, registry: PolicyRegistry, trace: Trace,
            valid: torch.Tensor, states: EmulatorState,
            params: RuntimeParams, faults: FaultPlan
            ) -> chunk_step_lib.KernelOut:
    """ONE launch of the chunk-step kernel over every chunk of the trace
    for the B design points of the stacked ``states`` / ``params`` (each
    tensor with a leading point axis; the table [B, n_pages, 8] is updated
    in place). ``trace`` and ``valid`` are [N], shared by every point and
    copied once a point, or [B, N]; ``faults`` is one shared plan or a
    stacked one."""
    cs = chunk_step_lib
    b = states.table.shape[0]
    with telemetry.span("chunk_step.pack"):
        ints, floats = cs._pack_scalars(params, _step_scalars(states))
        c_int, c_float = cs.pack_counters(states.counters)
        vec = [x.to(torch.int32).expand(b, -1).contiguous()
               for x in (*trace, valid)]
        plan = [x.expand(b, -1, -1).contiguous() for x in faults]
    return cs.chunk_step_cuda(cfg, registry, states.table, ints, floats,
                              states.bank_free, *vec, *plan, c_int, c_float)


def _emulate_kernel(cfg: EmulatorConfig, registry: PolicyRegistry,
                    trace: Trace, valid: torch.Tensor, state: EmulatorState,
                    params: RuntimeParams, faults: FaultPlan
                    ) -> tuple[EmulatorState, dict]:
    """Every chunk of the trace in ONE launch of the chunk-step kernel
    (which updates the table in place); returns ``state`` holding the
    final state, and the outputs."""
    out = _launch(cfg, registry, trace, valid, _index(state, None),
                  _index(params, None), faults)
    with telemetry.span("emulator.unpack"):
        return (_write_back(state, kernel_state(state.table, out)),
                kernel_outs(cfg, out, valid))


def _empty_outs(device, shape=(0,)) -> dict:
    z = torch.zeros(shape, dtype=torch.int32, device=device)
    return {"returns": z, "device": z, "latency": z, "faulted": z.bool(),
            "retired_page": z, "tombstone": z}


def _emulate_impl(cfg: EmulatorConfig, registry: PolicyRegistry, trace: Trace,
                  valid: torch.Tensor, state: EmulatorState,
                  params: RuntimeParams, faults: FaultPlan | None = None, *,
                  seq: bool = False, selected=None
                  ) -> tuple[EmulatorState, dict]:
    """Run the chunk step over a chunk-multiple trace and write the final
    state into ``state``'s own tensors (returned). Where
    :func:`chunk_step.use_chunk_step_kernel` picks the kernel, one launch
    runs the whole trace; otherwise the chunk loop of
    :func:`_emulate_batch_impl` at a point axis of one. ``seq=True`` is
    that loop with the sequential recurrences (``step_ref(seq=True)``):
    the kernel's plain version. ``selected`` (registry indices the run
    selects, where the caller knows them) spares the kernel route's
    user-policy check its read of ``policy_id``
    (:func:`chunk_step.refuse_user_policies`)."""
    if faults is None:
        faults = FaultPlan.empty(device=state.table.device)
    n = len(trace)
    if n % cfg.chunk:
        raise ValueError("pad the trace to a chunk multiple first")
    if n == 0:
        return state, _empty_outs(state.table.device)
    if not seq and chunk_step_lib.use_chunk_step_kernel(cfg, state.table):
        chunk_step_lib.refuse_user_policies(cfg, registry, params, selected)
        return _emulate_kernel(cfg, registry, trace, valid, state, params,
                               faults)
    new, outs = _chunk_loop(cfg, registry, trace, valid, _index(state, None),
                            _index(params, None), faults, seq)
    with telemetry.span("emulator.unpack"):
        return _write_back(state, _index(new, 0)), {k: v[0]
                                                    for k, v in outs.items()}


def init_states(cfg: EmulatorConfig, params: RuntimeParams) -> EmulatorState:
    """Fresh state of every design point of the stacked ``params`` (1-D
    tensors of length B), stacked: each point's table from its own
    ``n_fast_pages`` and ``pin_fast_fraction`` (one call for all B)."""
    with telemetry.span("emulator.init_states"):
        table = table_lib.init_table(cfg, params.n_fast_pages[:, None],
                                     params.pin_fast_fraction[:, None])
        return EmulatorState(table=table, **_fresh_fields(
            cfg, table.device, params.policy_id.shape))


def _emulate_batch_impl(cfg: EmulatorConfig, registry: PolicyRegistry,
                        trace: Trace, valid: torch.Tensor,
                        states: EmulatorState, params: RuntimeParams,
                        faults: FaultPlan | None = None, *, selected=None
                        ) -> tuple[EmulatorState, dict]:
    """The sweep's computation: :func:`_emulate_impl` over B design
    points, the JAX package's ``vmap`` written out as a leading point
    axis. ``states`` and ``params`` are stacked ([B, ...] every tensor);
    ``trace`` is [N], shared by every point, or [B, N] (a trace a
    channel); ``valid`` is [N]; ``faults`` is one shared plan or a stacked
    per-point one (:func:`faults.stack_plans`). The final states are
    written into ``states``' own tensors (returned with the [B, N]
    outputs).

    Where :func:`chunk_step.use_chunk_step_kernel` picks the kernel, ONE
    launch runs every point over every chunk. Otherwise (a CPU tensor, or
    ``"off"``) one chunk loop runs every point: each chunk is ONE
    ``step_batch`` over the B points, whose stage-2 gather is one call of
    ``ops.hmmu_lookup_fused`` (one launch of kernel A on a CUDA device)
    for all of them. ``selected`` is as in :func:`_emulate_impl`."""
    device = states.table.device
    if faults is None:
        faults = FaultPlan.empty(device=device)
    n, b = len(trace), states.table.shape[0]
    if n % cfg.chunk:
        raise ValueError("pad the trace to a chunk multiple first")
    if n == 0:
        return states, _empty_outs(device, (b, 0))
    if chunk_step_lib.use_chunk_step_kernel(cfg, states.table):
        chunk_step_lib.refuse_user_policies(cfg, registry, params, selected)
        out = _launch(cfg, registry, trace, valid, states, params, faults)
        with telemetry.span("emulator.unpack"):
            new = kernel_state(states.table, out, ALL)
            return (_write_back(states, new),
                    kernel_outs(cfg, out, valid, ALL))
    new, outs = _chunk_loop(cfg, registry, trace, valid, states, params,
                            faults, seq=False)
    with telemetry.span("emulator.unpack"):
        return _write_back(states, new), outs


# ---------------------------------------------------------------------------
# The dispatch-signature registry (the JAX package's entry-point cache).
#
# The JAX package compiles one program per (static geometry, frozen policy
# registry, batch?, donate?, shape signature) and counts its cache entries as
# ``Engine.compile_count``. Here the kernels are built once per source
# (``kernels/build.py``) and nothing is compiled per key, but every dispatch
# still records its key under the same rules, so the count means what the
# serving contract needs: a dispatch shape outside the warmed buckets shows
# up as a new key.
# ---------------------------------------------------------------------------
_DISPATCH_KEYS: set[tuple] = set()


def record_dispatch(cfg: EmulatorConfig, registry: PolicyRegistry, *,
                    batch: bool = False, donate: bool = False,
                    shape_sig: tuple = ()) -> tuple:
    """Record (and return) the key of one dispatch: ``(static_key(cfg),
    registry, batch, donate, shape_sig)``, as the JAX package keys its
    compiled entry points."""
    key = (static_key(cfg), registry, batch, donate, shape_sig)
    _DISPATCH_KEYS.add(key)
    return key


def dispatch_key_count(skey: tuple | None = None) -> int:
    """Distinct dispatch signatures recorded in this process: all
    geometries, or one (``skey`` from :func:`config.static_key`). Backs
    ``Engine.compile_count``."""
    if skey is None:
        return len(_DISPATCH_KEYS)
    return sum(1 for k in _DISPATCH_KEYS if k[0] == skey)
