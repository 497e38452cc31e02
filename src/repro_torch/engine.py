"""The session API of the PyTorch port: :class:`Engine`.

    from repro_torch import Engine
    from repro_torch.core import paper_platform

    engine = Engine(paper_platform().with_(chunk=512))      # on cuda
    state, outs = engine.run(trace)                 # one design point
    state, outs = engine.run(trace2, state=state)   # continue, in place

An ``Engine`` owns the static geometry, a frozen
:class:`~repro_torch.core.policies.PolicyRegistry` and its device. It
runs on ``cuda`` unless the caller asks for ``device="cpu"``; with no
CUDA device and no explicit CPU it raises — it never moves to the CPU
quietly. On a CUDA device the chunk step is the hand-written CUDA kernel
(or, with ``chunk_step_kernel="off"``, the scan path whose stage-2 gather
is the CUDA lookup kernel).

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
from .core.emulator import (EmulatorState, Trace, _emulate_impl, clone_state,
                            init_state, pad_trace)
from .core.faults import FaultPlan
from .core.policies import PolicyRegistry


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


__all__ = ["Engine", "RunResult", "PolicyRegistry", "resolve_device"]
