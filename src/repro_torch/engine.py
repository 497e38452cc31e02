"""The session API of the PyTorch port: :class:`Engine`.

    from repro_torch import Engine
    from repro_torch.core import paper_platform

    engine = Engine(paper_platform().with_(chunk=512))      # on cuda
    state, outs = engine.run(trace)                 # one design point
    state, outs = engine.run(trace2, state=state)   # continue (donated)
    state, outs = engine.run_stream(segments)       # a segmented trace
    res = engine.sweep(spec, trace)                 # a grid, one launch
    res = engine.continue_sweep(res, trace2)        # the warm grid

An ``Engine`` owns the static geometry, a frozen
:class:`~repro_torch.core.policies.PolicyRegistry` and its device. It
runs on ``cuda`` unless the caller asks for ``device="cpu"``; with no
CUDA device and no explicit CPU it raises — it never moves to the CPU
quietly. On a CUDA device the chunk step is the hand-written CUDA kernel
(or, with ``chunk_step_kernel="off"``, the scan path whose stage-2 gather
is the CUDA lookup kernel). A sweep runs every design point in ONE
launch of the chunk-step kernel; on ``"off"`` or the CPU, in one chunk
loop over the point axis with ONE lookup launch a chunk for all points.
``mesh=`` splits a sweep's point axis over a sequence of devices (the
reference's 1-D mesh), one process driving them all: each share runs
from one launch (or one chunk loop) on its device, every share launched
before any is waited on, and the results come back in point order.

Every dispatch records its signature (``core.emulator.record_dispatch``,
the JAX package's entry-point key); :attr:`Engine.compile_count` counts
them per geometry, so a trace length outside a warmed set shows up as a
new key exactly where the JAX package would compile a new program.

States passed to :meth:`Engine.run`, :meth:`Engine.run_stream` and
:meth:`Engine.continue_sweep` are **donated by default**, as in the JAX
package: the run updates their memory in place (the packed table moves
forward without a copy) and returns the result as new tensor objects over
that memory. The passed-in state is consumed: passing it again raises
``RuntimeError``. ``donate=False`` clones the state first and leaves it
live.

Policies registered with ``core.policies.register`` run on the CPU and,
on a CUDA device, with ``chunk_step_kernel="off"``; the chunk-step
kernel (``"auto"`` / ``"on"``) runs the six built-ins only and refuses a
dispatch that selects any other policy, by name.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, NamedTuple

import torch

from . import telemetry
from .core import counters as counters_lib
from .core.config import EmulatorConfig, RuntimeParams, static_key
from .core.emulator import (EmulatorState, Trace, _emulate_batch_impl,
                            _emulate_impl, _tensors, clone_state,
                            dispatch_key_count,
                            init_state, init_states, pad_trace,
                            record_dispatch)
from .core.faults import FaultPlan
from .core.policies import PolicyRegistry
from .device import resolve_device
from .launch.mesh import local_devices
from .sweep.results import SweepResult
from .sweep.spec import DesignPoint, SweepSpec, build_points


class RunResult(NamedTuple):
    """Outcome of :meth:`Engine.run`: unpacks as ``(state, outs)``;
    ``outs`` maps ``returns`` / ``device`` / ``latency`` / ``faulted`` /
    ``retired_page`` / ``tombstone`` to per-request tensors (trimmed to
    the trace length)."""

    state: EmulatorState
    outs: dict

    def summary(self) -> dict:
        """Host-side counter summary (per-tier traffic, latency, energy)."""
        return counters_lib.summary(self.state.counters)


def stack_params(points: list[DesignPoint], device=None) -> RuntimeParams:
    """Stack per-point RuntimeParams into 1-D tensors of length B (the
    point axis) on ``device``."""
    with telemetry.span("sweep.stack_params"):
        ps = [p.params() for p in points]
        return RuntimeParams(*(torch.stack(xs).to(device)
                               for xs in zip(*ps)))


def sweep_mesh(device=None) -> tuple:
    """The sweep's mesh over every local device of ``device``'s type:
    each CUDA device for a CUDA engine, ``(cpu,)`` for a CPU one."""
    return local_devices(resolve_device(device).type)


def _map_state(fn, x):
    """``fn`` over every tensor of a (nested) state tuple."""
    return type(x)(*(_map_state(fn, y) for y in x)) \
        if isinstance(x, tuple) else fn(x)


def _pad_points(tree, pad: int):
    """The leading (point) axis of every tensor of ``tree`` padded by
    ``pad`` copies of the last point (the reference's
    ``_pad_to_multiple``)."""
    if not pad:
        return tree
    return _map_state(lambda x: torch.cat(
        [x, x[-1:].expand(pad, *x.shape[1:])]), tree)


def _prefetched(segments: Iterable[Trace], depth: int,
                device: torch.device):
    """Keep ``depth`` upcoming segments on their way to ``device`` ahead of
    consumption, so the host-to-device copy of segment ``k+1`` overlaps
    the emulation of segment ``k``. On a CUDA device each segment still on
    the host is staged in pinned memory and copied (``non_blocking``) on a
    side stream; the consuming stream waits on the copy's event, each
    copied tensor is recorded on that stream, and the pinned buffers stay
    alive until their copy's event has passed. Elsewhere the segments pass
    through unchanged. Values are never changed, only when they move."""
    if device.type != "cuda":
        yield from segments
        return
    side = torch.cuda.Stream(device)
    it = iter(segments)
    buf: deque = deque()     # (segment, its copy's event or None)
    held: deque = deque()    # (copy event, pinned host tensors)

    def pull():
        try:
            seg = next(it)
        except StopIteration:
            return
        if all(x.device == device for x in seg):
            buf.append((seg, None))
            return
        pinned = [x if x.is_cuda or x.is_pinned() else x.pin_memory()
                  for x in seg]
        with torch.cuda.stream(side):
            moved = Trace(*(x.to(device, non_blocking=True) for x in pinned))
            ev = torch.cuda.Event()
            ev.record(side)
        buf.append((moved, ev))
        held.append((ev, pinned))

    for _ in range(max(depth, 1)):
        pull()
    while buf:
        seg, ev = buf.popleft()
        if ev is not None:
            cur = torch.cuda.current_stream(device)
            cur.wait_event(ev)
            for x in seg:
                x.record_stream(cur)
        while held and held[0][0].query():
            held.popleft()
        yield seg
        pull()
    for ev, _ in held:
        ev.synchronize()


# The attribute that marks a tensor of a donated (consumed) state.
_CONSUMED = "_repro_consumed"


def _refuse_consumed(what: str, state) -> None:
    """Raise if ``state`` holds a tensor of a state an earlier run
    consumed (donated)."""
    if any(getattr(t, _CONSUMED, False) for t in _tensors(state)):
        raise RuntimeError(
            f"{what} was consumed by an earlier run that donated it (updated "
            "its memory in place, as the JAX package's donation deletes its "
            "buffers): pass the state that run returned, or run with "
            "donate=False to keep a state for reuse")


def _renew(state):
    """Mark the tensors of a donated ``state`` consumed and return the
    same values as new tensor objects over the same memory: the live
    state the run hands back."""
    if isinstance(state, tuple):
        return type(state)(*(_renew(x) for x in state))
    fresh = state.view_as(state)
    setattr(state, _CONSUMED, True)
    return fresh


def as_registry(registry) -> PolicyRegistry:
    """``None`` / a tuple of names / a ``PolicyRegistry`` -> a registry
    (None = every registered policy, in registration order)."""
    if isinstance(registry, PolicyRegistry):
        return registry
    return PolicyRegistry.snapshot(registry)


class Engine:
    """A stateful session over one static platform geometry on one
    device. ``registry`` optionally restricts the policy table (a
    ``PolicyRegistry`` or a tuple of registered names); by default the
    engine snapshots every policy registered when it is made."""

    def __init__(self, cfg: EmulatorConfig, *, registry=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.registry: PolicyRegistry = as_registry(registry)
        self.static_key = static_key(cfg)
        if cfg.policy in self.registry:
            self._default_params = RuntimeParams.from_config(
                cfg, device=self.device,
                policy_id=self.registry.index(cfg.policy))
        else:
            self._default_params = None
        self._no_faults: FaultPlan | None = None

    @property
    def compile_count(self) -> int:
        """Dispatch signatures recorded for this geometry, by every
        session of the process (``core.emulator.dispatch_key_count``)."""
        return dispatch_key_count(self.static_key)

    @property
    def params(self) -> RuntimeParams:
        """The config's runtime design point, with ``policy_id`` indexing
        this engine's registry."""
        if self._default_params is None:
            raise ValueError(
                f"config policy {self.cfg.policy!r} is not in this "
                f"engine's registry {self.registry.names}: pass params= "
                "with a policy_id indexing the engine's registry")
        return self._default_params

    def init_state(self, params: RuntimeParams | None = None
                   ) -> EmulatorState:
        """Fresh platform state for this geometry on the engine's
        device."""
        return init_state(self.cfg, self.params if params is None
                          else params)

    @staticmethod
    def _resolve_donate(donate: bool | None, state) -> bool:
        """Tri-state donate: None (the default) updates a passed state in
        place; an explicit True with no state raises."""
        if donate and state is None:
            raise ValueError(
                "donate=True requires state=...: a fresh run builds its "
                "own state and has nothing of yours to update")
        return True if donate is None else donate

    def _check_device(self, what: str, t: torch.Tensor) -> None:
        if t.device != self.device:
            raise ValueError(f"{what} is on {t.device}, the engine on "
                             f"{self.device}")

    @staticmethod
    def _fault_sig(faults):
        return None if faults is None else (faults.shape_sig,
                                            faults.is_batched)

    def _plan(self, faults: FaultPlan | None) -> FaultPlan:
        """``faults`` on the engine's device; None is the empty plan, made
        once per engine (equal to no plan)."""
        if faults is not None:
            return faults.to(self.device)
        if self._no_faults is None:
            self._no_faults = FaultPlan.empty(device=self.device)
        return self._no_faults

    def _selected(self, params: RuntimeParams):
        """The registry indices a run at ``params`` selects, where the
        host knows them without reading the device (the engine's default
        point); else None."""
        if params is self._default_params:
            return (self.registry.index(self.cfg.policy),)
        return None

    def _dispatch(self, trace: Trace, valid: torch.Tensor, state, params,
                  donate: bool, faults) -> tuple[EmulatorState, dict]:
        """One run of a padded trace on the engine's device: records the
        dispatch key as ``repro.Engine._entry_for`` builds it (carried
        state or fresh, donation only of a carried state, the padded
        length and the fault plan's shapes), then emulates. A donated
        state is consumed; the result comes back as new objects."""
        carried = state is not None
        if carried:
            self._check_device("state", state.table)
            _refuse_consumed("the state", state)
        record_dispatch(self.cfg, self.registry, donate=donate and carried,
                        shape_sig=(len(trace), False, not carried,
                                   self._fault_sig(faults)))
        if state is None:
            state = self.init_state(params)
        elif not donate:
            state = clone_state(state)
        state, outs = _emulate_impl(self.cfg, self.registry, trace, valid,
                                    state, params, self._plan(faults),
                                    selected=self._selected(params))
        return (_renew(state) if carried and donate else state), outs

    def run(self, trace: Trace, *, params: RuntimeParams | None = None,
            state: EmulatorState | None = None,
            valid: torch.Tensor | None = None,
            donate: bool | None = None,
            faults: FaultPlan | None = None) -> RunResult:
        """Run one trace through the platform at one design point.

        The trace (moved to the engine's device) is padded to a chunk
        multiple and the outputs are trimmed back; pass ``valid`` only
        with an already padded trace. ``state`` continues a previous run
        and is **donated** (updated in place, then consumed: use the
        returned state) unless ``donate=False``. ``faults``
        injects a :class:`FaultPlan` (keyed on the state's absolute
        ``chunk_idx``); None is the empty plan.
        """
        with telemetry.span("engine.run"):
            params = self.params if params is None else params
            self._check_device("params", params.policy_id)
            donate = self._resolve_donate(donate, state)
            trace = trace.to(self.device)
            n = len(trace)
            if valid is None:
                if n % self.cfg.chunk:
                    trace, valid = pad_trace(self.cfg, trace)
                else:
                    valid = torch.ones(n, dtype=torch.bool, device=self.device)
            elif n % self.cfg.chunk:
                raise ValueError("explicit valid= requires a chunk-multiple "
                                 "trace (use pad_trace, or drop valid=)")
            state, outs = self._dispatch(trace, valid.to(self.device), state,
                                         params, donate, faults)
            if len(trace) != n:
                outs = {k: v[:n] for k, v in outs.items()}
            return RunResult(state, outs)

    def run_stream(self, segments: Iterable[Trace], *,
                   params: RuntimeParams | None = None,
                   state: EmulatorState | None = None,
                   donate: bool | None = None,
                   prefetch: int = 0,
                   faults: FaultPlan | None = None) -> RunResult:
        """Emulate a trace delivered as segments of any lengths, bitwise
        equal to one :meth:`run` over their concatenation.

        Requests are re-chunked across segment boundaries: each dispatch
        takes the chunk multiple at hand and carries the sub-chunk
        remainder into the next segment; the last remainder is padded.
        Intermediate states belong to the engine and are updated in
        place; ``donate`` governs only a caller's ``state`` (updated in
        place by default, as in :meth:`run`).

        ``prefetch`` > 0 keeps that many upcoming segments on their way to
        the card ahead of use (pinned host buffers, a side stream): the
        copy of segment ``k+1`` overlaps the emulation of segment ``k``.
        On the CPU it changes nothing. One ``faults`` plan spans the whole
        stream (its events are keyed on the carried ``chunk_idx``).
        """
        with telemetry.span("engine.run"):
            params = self.params if params is None else params
            self._check_device("params", params.policy_id)
            donate = self._resolve_donate(donate, state)
            if prefetch:
                segments = _prefetched(segments, prefetch, self.device)
            chunk = self.cfg.chunk
            carry: Trace | None = None
            parts: list[dict] = []
            first = True
            for seg in segments:
                seg = seg.to(self.device)
                buf = seg if carry is None else Trace(
                    *(torch.cat([a, b]) for a, b in zip(carry, seg)))
                m = len(buf) - len(buf) % chunk
                if m == 0:
                    carry = buf
                    continue
                head = Trace(*(x[:m] for x in buf))
                carry = Trace(*(x[m:] for x in buf)) if m < len(buf) else None
                valid = torch.ones(m, dtype=torch.bool, device=self.device)
                state, outs = self._dispatch(head, valid, state, params,
                                             donate if first else True, faults)
                parts.append(outs)
                first = False
            if carry is not None and len(carry):
                n = len(carry)
                padded, valid = pad_trace(self.cfg, carry)
                state, outs = self._dispatch(padded, valid, state, params,
                                             donate if first else True, faults)
                parts.append({k: v[:n] for k, v in outs.items()})
            if not parts:
                z = torch.zeros(0, dtype=torch.int32, device=self.device)
                if state is None:
                    state = self.init_state(params)
                return RunResult(state, {"returns": z, "device": z,
                                         "latency": z})
            return RunResult(state, {k: torch.cat([p[k] for p in parts])
                                     for k in parts[0]})

    def run_channels(self, traces: Trace, *,
                     params: RuntimeParams | None = None,
                     faults: FaultPlan | None = None):
        """FPGA-style spatial parallelism: emulate independent trace
        channels at once. ``traces`` has a leading channel axis ([C, N],
        N a chunk multiple); ``params`` and the optional shared ``faults``
        plan apply to every channel, each from a fresh state. Returns
        ``(states, outs)`` with the channel axis leading; on a CUDA device
        the channels are the points of ONE chunk-step launch (on ``"off"``
        or the CPU, of one chunk loop over the point axis)."""
        with telemetry.span("engine.run"):
            params = self.params if params is None else params
            self._check_device("params", params.policy_id)
            traces = traces.to(self.device)
            c, n = traces.page.shape
            if n % self.cfg.chunk:
                raise ValueError(f"each channel must hold a multiple of the "
                                 f"chunk ({self.cfg.chunk}), got {n}")
            stacked = RuntimeParams(*(x.expand(c).contiguous()
                                      for x in params))
            valid = torch.ones(n, dtype=torch.bool, device=self.device)
            record_dispatch(self.cfg, self.registry,
                            shape_sig=("channels", (c, n),
                                       self._fault_sig(faults)))
            if faults is not None:
                faults = faults.to(self.device)
            return _emulate_batch_impl(self.cfg, self.registry, traces, valid,
                                       init_states(self.cfg, stacked), stacked,
                                       faults, selected=self._selected(params))

    # ------------------------------------------------------------------
    # design-space sweeps
    # ------------------------------------------------------------------
    def _sweep_batch(self, spec):
        """Normalise spec / points / params into (points, registry,
        stacked params, the registry indices selected where known)."""
        with telemetry.span("sweep.build_points"):
            if isinstance(spec, RuntimeParams):
                # A pre-stacked batch: policy_id already indexes this engine's
                # registry; index-only points label the rows.
                n = int(spec.policy_id.shape[0])
                points = [DesignPoint(index=i, coords=(("point", i),),
                                      cfg=self.cfg) for i in range(n)]
                return points, self.registry, spec, None
            points = list(spec) if isinstance(spec, (list, tuple)) \
                else build_points(spec)
            if not points:
                raise ValueError("empty sweep")
            keys = {static_key(p.cfg) for p in points}
            if keys != {self.static_key}:
                raise ValueError("points disagree on this engine's static "
                                 f"geometry: {keys}")
            # The kernel switches only over the policies present, in order of
            # first appearance; each point's policy_id indexes that subset.
            names: list[str] = []
            for p in points:
                if p.cfg.policy not in names:
                    names.append(p.cfg.policy)
            registry = self.registry.subset(names)
            ids = torch.tensor([registry.index(p.cfg.policy) for p in points],
                               dtype=torch.int32, device=self.device)
        params = stack_params(points, self.device)._replace(policy_id=ids)
        return points, registry, params, tuple(range(len(registry)))

    def sweep(self, spec: SweepSpec | list[DesignPoint] | RuntimeParams,
              trace: Trace, *, mesh=None, states=None,
              donate: bool | None = None,
              faults: FaultPlan | None = None) -> SweepResult:
        """Evaluate every design point of ``spec`` on ``trace``; on a CUDA
        device in ONE launch of the chunk-step kernel (on ``"off"`` or the
        CPU, one chunk loop over the point axis: each chunk one step for
        every point, with one lookup launch).

        ``spec``: a :class:`SweepSpec` grid, a ``DesignPoint`` list, or a
        pre-stacked ``RuntimeParams`` batch (1-D tensors, ``policy_id``
        indexing this engine's registry). All points must share this
        engine's static geometry. The trace is padded to a chunk multiple;
        the outputs keep the padding, [B, N] each.

        ``mesh``: None runs every point on the engine's device;
        ``"auto"`` is :func:`sweep_mesh` of it; a sequence of devices of
        the engine's type (repeats allowed: ``(cuda:0, cuda:0)`` is two
        shares of one card) splits the point axis into equal contiguous
        shares, one a device, the last point repeated to pad the count to
        a multiple (states and a stacked fault plan likewise). Every
        share is launched before any is waited on; states and outputs
        are gathered onto the engine's device in point order and the
        padding dropped. Bitwise equal to ``mesh=None``.

        ``states``: stacked per-point ``EmulatorState`` (a previous
        ``SweepResult.states``) to continue from, donated (updated in
        place, then consumed) unless
        ``donate=False``, which clones it first.

        ``faults``: one shared :class:`FaultPlan` for every point, or a
        stacked per-point batch (``faults.stack_plans`` of plans padded
        with ``pad_plan`` to one shape).
        """
        with telemetry.span("engine.sweep"):
            points, registry, params, selected = self._sweep_batch(spec)
            return self._sweep_exec(points, registry, params, trace,
                                    mesh=mesh, states=states, donate=donate,
                                    faults=faults, selected=selected)

    def _mesh(self, mesh) -> tuple:
        """``mesh=`` as a tuple of devices of the engine's type (None is
        the engine's device alone); anything else raises."""
        if mesh is None:
            return (self.device,)
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh={mesh!r}: only 'auto' is a name")
            mesh = sweep_mesh(self.device)
        if not isinstance(mesh, (list, tuple)):
            raise TypeError(
                f"mesh= takes None, 'auto' or a sequence of devices, not "
                f"{type(mesh).__name__}")
        if not mesh:
            raise ValueError("mesh=(): an empty mesh has no device to run "
                             "the sweep on")
        devices = tuple(torch.device(d) for d in mesh)
        for d in devices:
            if d.type != self.device.type:
                raise ValueError(
                    f"mesh device {d} is not of the engine's type "
                    f"({self.device}): a sweep runs where its engine does")
        return tuple(resolve_device(d) for d in devices)

    def _sweep_shares(self, registry, mesh, trace, valid, states, params,
                      faults, selected):
        """The point axis split into ``len(mesh)`` equal contiguous shares
        (padded by repeating the last point), each run on its device, all
        launched before any is read; returns each share's (states,
        outs)."""
        n = len(params.policy_id)
        pad = (-n) % len(mesh)
        per = (n + pad) // len(mesh)
        params = _pad_points(params, pad)
        if states is not None:
            states = _pad_points(states, pad)
        batched = faults is not None and faults.is_batched
        if batched:
            faults = _pad_points(faults, pad)
        shares = []
        for i, dev in enumerate(mesh):
            share = lambda x: x[i * per:(i + 1) * per].to(dev)
            p = _map_state(share, params)
            st = (init_states(self.cfg, p) if states is None
                  else _map_state(share, states))
            f = (_map_state(share, faults) if batched else
                 None if faults is None else faults.to(dev))
            shares.append(_emulate_batch_impl(
                self.cfg, registry, trace.to(dev), valid.to(dev), st, p, f,
                selected=selected))
        return shares

    def _gather(self, shares, n: int):
        """The shares' states and outputs on the engine's device, in point
        order, the padding dropped. One share has no padding and is
        returned as it is (moved home), not copied."""
        with telemetry.span("engine.gather"):
            if len(shares) == 1:
                st, outs = shares[0]
                home = lambda x: x.to(self.device)
                return (_map_state(home, st),
                        {k: home(v) for k, v in outs.items()})
            cat = lambda *xs: torch.cat([x.to(self.device) for x in xs])[:n]
            flat = [_tensors(st) for st, _ in shares]
            it = iter([cat(*col) for col in zip(*flat)])
            states = _map_state(lambda _: next(it), shares[0][0])
            outs = {k: cat(*(o[k] for _, o in shares)) for k in shares[0][1]}
            return states, outs

    def _sweep_exec(self, points, registry, params, trace, *, mesh, states,
                    donate, faults=None, selected=None) -> SweepResult:
        """Run an already normalised (points, registry, stacked params)
        batch: shared by :meth:`sweep` and :meth:`continue_sweep`. Donated
        ``states`` are consumed; the result holds new objects."""
        devices = self._mesh(mesh)
        if donate is None:
            donate = states is not None
        if donate and states is None:
            raise ValueError(
                "donate=True requires states=... (a previous "
                "SweepResult.states): a fresh sweep builds its own states "
                "and has nothing of yours to update")
        self._check_device("params", params.policy_id)
        carried = states is not None
        if carried:
            self._check_device("states", states.table)
            _refuse_consumed("the sweep's states", states)
        padded, valid = pad_trace(self.cfg, trace.to(self.device))
        record_dispatch(self.cfg, registry, batch=True, donate=donate,
                        shape_sig=(len(padded), len(points), states is None,
                                   None if mesh is None else devices,
                                   self._fault_sig(faults)))
        if carried and not donate:
            states = clone_state(states)
        if faults is not None:
            faults = faults.to(self.device)
        gathered, outs = self._gather(self._sweep_shares(
            registry, devices, padded, valid, states, params, faults,
            selected),
            len(points))
        if carried and donate:
            _renew(states)      # consumed; the shares are other objects
        return SweepResult(points=points, states=gathered, outs=outs,
                           params=params, registry=registry)

    def continue_sweep(self, result: SweepResult, trace: Trace, *,
                       mesh=None, donate: bool = True,
                       faults: FaultPlan | None = None) -> SweepResult:
        """Continue a previous sweep on a further trace segment: every
        point resumes from its own warm state (donated, so ``result`` is
        consumed, unless ``donate=False``), replaying the recorded stacked
        params and registry of ``result``."""
        with telemetry.span("engine.sweep"):
            return self._sweep_exec(result.points, result.registry,
                                    result.params, trace, mesh=mesh,
                                    states=result.states, donate=donate,
                                    faults=faults)


__all__ = ["Engine", "RunResult", "PolicyRegistry", "resolve_device",
           "stack_params", "sweep_mesh"]
