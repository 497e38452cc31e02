"""Carry a state across between the JAX package and the port.

Inputs are dicts of numpy arrays keyed by field name (nested dicts for
``dma`` and ``counters``), the shape ``state_to_numpy`` returns and the
shape a test builds from the JAX package's ``RuntimeParams`` /
``EmulatorState`` / ``FaultPlan``. Dtypes are kept (int32, float32), so a
state crosses over bit for bit, and so do shapes: every field may carry a
leading design-point axis (a sweep's stacked params, states and plans).
This plays the part weights play for a model: both sides start from the
same, possibly adversarial, state.

``model_params_from_numpy`` carries a model's parameters (or a decode
cache) across the same way: the JAX package's ``init_params`` tree as
numpy arrays, shapes and dtypes kept (bfloat16 included).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.config import FLOAT_PARAM_FIELDS, RuntimeParams
from .core.counters import Counters
from .core.dma import DMAState
from .core.emulator import EmulatorState
from .core.faults import FaultPlan


def _t(v, device, dtype=None):
    a = np.array(v, dtype=dtype, order="C", copy=True)   # keeps 0-dim
    return torch.from_numpy(a).to(device)


def params_from_numpy(d: dict, device=None) -> RuntimeParams:
    return RuntimeParams(**{
        f: _t(d[f], device,
              np.float32 if f in FLOAT_PARAM_FIELDS else np.int32)
        for f in RuntimeParams._fields})


def state_from_numpy(d: dict, device=None) -> EmulatorState:
    vals = {}
    for f in EmulatorState._fields:
        if f == "dma":
            vals[f] = DMAState(**{k: _t(d[f][k], device, np.int32)
                                  for k in DMAState._fields})
        elif f == "counters":
            vals[f] = Counters(**{k: _t(d[f][k], device)
                                  for k in Counters._fields})
        else:
            vals[f] = _t(d[f], device, np.int32)
    return EmulatorState(**vals)


def faults_from_numpy(d: dict, device=None) -> FaultPlan:
    return FaultPlan(transient=_t(d["transient"], device, np.int32),
                     deaths=_t(d["deaths"], device, np.int32))


def _to_numpy(x) -> dict:
    """A NamedTuple of tensors (nested for ``dma`` / ``counters``) ->
    dicts of numpy arrays."""
    return {k: _to_numpy(v) if isinstance(v, tuple)
            else v.detach().cpu().numpy() for k, v in x._asdict().items()}


def state_to_numpy(state: EmulatorState) -> dict:
    return _to_numpy(state)


def params_to_numpy(params: RuntimeParams) -> dict:
    return _to_numpy(params)


def faults_to_numpy(plan: FaultPlan) -> dict:
    return _to_numpy(plan)


def model_params_from_numpy(tree, device=None):
    """A model's parameter tree (nested dicts of numpy arrays, the JAX
    package's ``init_params`` after ``np.asarray``), or a decode cache
    (Hymba's is a tuple of per-layer dicts) -> the same tree of tensors
    on ``device``, bit for bit."""
    if isinstance(tree, dict):
        return {k: model_params_from_numpy(v, device)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(model_params_from_numpy(v, device) for v in tree)
    a = np.array(tree, order="C", copy=True)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: no torch view
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)
