"""The session API of the PyTorch port: :class:`Engine`.

    from repro_torch import Engine
    from repro_torch.core import paper_platform

    engine = Engine(paper_platform().with_(chunk=512))      # on cuda
    state, outs = engine.run(trace)                 # one design point
    state, outs = engine.run(trace2, state=state)   # continue, in place
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
The multi-card sweep (``mesh=``) is not ported yet and raises.

States passed to :meth:`Engine.run` are **updated in place by default**
(the JAX package donates them): the packed table moves forward without a
copy and the passed-in state must not be reused. ``donate=False`` clones
the state first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .core import counters as counters_lib
from .core.config import EmulatorConfig, RuntimeParams, static_key
from .core.emulator import (EmulatorState, Trace, _emulate_batch_impl,
                            _emulate_impl, clone_state, init_state,
                            init_states, pad_trace)
from .core.faults import FaultPlan
from .core.policies import PolicyRegistry
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
    ps = [p.params() for p in points]
    return RuntimeParams(*(torch.stack(xs).to(device) for xs in zip(*ps)))


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``, which must
    exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port's plain "
                "PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def as_registry(registry) -> PolicyRegistry:
    """``None`` / a tuple of names / a ``PolicyRegistry`` -> a registry
    (None = every built-in policy, in registration order)."""
    if isinstance(registry, PolicyRegistry):
        return registry
    return PolicyRegistry.snapshot(registry)


class Engine:
    """A stateful session over one static platform geometry on one
    device. ``registry`` optionally restricts the policy table (a
    ``PolicyRegistry`` or a tuple of built-in names)."""

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

    def run(self, trace: Trace, *, params: RuntimeParams | None = None,
            state: EmulatorState | None = None,
            valid: torch.Tensor | None = None,
            donate: bool | None = None,
            faults: FaultPlan | None = None) -> RunResult:
        """Run one trace through the platform at one design point.

        The trace (moved to the engine's device) is padded to a chunk
        multiple and the outputs are trimmed back; pass ``valid`` only
        with an already padded trace. ``state`` continues a previous run
        and is **updated in place** unless ``donate=False``. ``faults``
        injects a :class:`FaultPlan` (keyed on the state's absolute
        ``chunk_idx``); None is the empty plan.
        """
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
        valid = valid.to(self.device)
        if state is None:
            state = self.init_state(params)
        else:
            self._check_device("state", state.table)
            if not donate:
                state = clone_state(state)
        if faults is not None:
            faults = faults.to(self.device)
        state, outs = _emulate_impl(self.cfg, self.registry, trace, valid,
                                    state, params, faults)
        if len(trace) != n:
            outs = {k: v[:n] for k, v in outs.items()}
        return RunResult(state, outs)

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
        params = self.params if params is None else params
        self._check_device("params", params.policy_id)
        traces = traces.to(self.device)
        c, n = traces.page.shape
        if n % self.cfg.chunk:
            raise ValueError(f"each channel must hold a multiple of the "
                             f"chunk ({self.cfg.chunk}), got {n}")
        stacked = RuntimeParams(*(x.expand(c).contiguous() for x in params))
        valid = torch.ones(n, dtype=torch.bool, device=self.device)
        if faults is not None:
            faults = faults.to(self.device)
        return _emulate_batch_impl(self.cfg, self.registry, traces, valid,
                                   init_states(self.cfg, stacked), stacked,
                                   faults)

    # ------------------------------------------------------------------
    # design-space sweeps
    # ------------------------------------------------------------------
    def _sweep_batch(self, spec):
        """Normalise spec / points / params into (points, registry,
        stacked params)."""
        if isinstance(spec, RuntimeParams):
            # A pre-stacked batch: policy_id already indexes this engine's
            # registry; index-only points label the rows.
            n = int(spec.policy_id.shape[0])
            points = [DesignPoint(index=i, coords=(("point", i),),
                                  cfg=self.cfg) for i in range(n)]
            return points, self.registry, spec
        points = list(spec) if isinstance(spec, (list, tuple)) \
            else build_points(spec)
        if not points:
            raise ValueError("empty sweep")
        keys = {static_key(p.cfg) for p in points}
        if keys != {self.static_key}:
            raise ValueError(
                f"points disagree on this engine's static geometry: {keys}")
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
        return points, registry, params

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

        ``mesh``: only None; the multi-card sweep is not ported yet
        (ROADMAP.md §1) and raises rather than running on one card.

        ``states``: stacked per-point ``EmulatorState`` (a previous
        ``SweepResult.states``) to continue from, updated in place unless
        ``donate=False``, which clones it first.

        ``faults``: one shared :class:`FaultPlan` for every point, or a
        stacked per-point batch (``faults.stack_plans`` of plans padded
        with ``pad_plan`` to one shape).
        """
        points, registry, params = self._sweep_batch(spec)
        return self._sweep_exec(points, registry, params, trace, mesh=mesh,
                                states=states, donate=donate, faults=faults)

    def _sweep_exec(self, points, registry, params, trace, *, mesh, states,
                    donate, faults=None) -> SweepResult:
        """Run an already normalised (points, registry, stacked params)
        batch: shared by :meth:`sweep` and :meth:`continue_sweep`."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: the multi-card sweep (torch.distributed over the "
                "point axis) is not ported yet; pass mesh=None to run every "
                "point on this engine's device")
        if donate is None:
            donate = states is not None
        if donate and states is None:
            raise ValueError(
                "donate=True requires states=... (a previous "
                "SweepResult.states): a fresh sweep builds its own states "
                "and has nothing of yours to update")
        self._check_device("params", params.policy_id)
        padded, valid = pad_trace(self.cfg, trace.to(self.device))
        if states is None:
            states = init_states(self.cfg, params)
        else:
            self._check_device("states", states.table)
            if not donate:
                states = clone_state(states)
        if faults is not None:
            faults = faults.to(self.device)
        states, outs = _emulate_batch_impl(self.cfg, registry, padded, valid,
                                           states, params, faults)
        return SweepResult(points=points, states=states, outs=outs,
                           params=params, registry=registry)

    def continue_sweep(self, result: SweepResult, trace: Trace, *,
                       mesh=None, donate: bool = True,
                       faults: FaultPlan | None = None) -> SweepResult:
        """Continue a previous sweep on a further trace segment: every
        point resumes from its own warm state (updated in place unless
        ``donate=False``), replaying the recorded stacked params and
        registry of ``result``."""
        return self._sweep_exec(result.points, result.registry,
                                result.params, trace, mesh=mesh,
                                states=result.states, donate=donate,
                                faults=faults)


__all__ = ["Engine", "RunResult", "PolicyRegistry", "resolve_device",
           "stack_params"]
