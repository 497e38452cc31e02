"""What the harness takes from the program under test, ``repro_torch``:
its session API, built from a configuration file, and the host-side
record of an answer that :mod:`judge` compares."""
from __future__ import annotations

import torch


def platform(fields: dict):
    """The program's ``EmulatorConfig`` for a configuration file's
    ``platform`` (technologies by name)."""
    from repro_torch.core.config import TECHNOLOGIES, EmulatorConfig
    kw = dict(fields)
    kw["fast"] = TECHNOLOGIES[kw["fast"]]
    kw["slow"] = TECHNOLOGIES[kw["slow"]]
    return EmulatorConfig(**kw)


def trace_on(trace, device: torch.device):
    """The harness's trace as the program's ``Trace`` on ``device``."""
    from repro_torch.core.emulator import Trace
    return Trace(*(x.to(device) for x in trace))


def _flat(x, prefix: str = "") -> dict:
    out = {}
    for name, v in zip(x._fields, x):
        if isinstance(v, tuple):
            out.update(_flat(v, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = v
    return out


def record(state, outs: dict, readout: list, n: int, batched: bool
           ) -> dict:
    """The record of one answer on the host: each output [B, n] and each
    state field [B, ...] (one run's gain a point axis of one), and the
    readout, one dict a point."""
    lead = (lambda x: x) if batched else (lambda x: x[None])
    return {"outs": {k: lead(v)[..., :n].cpu() for k, v in outs.items()},
            "state": {k: lead(v).cpu() for k, v in _flat(state).items()},
            "readout": readout}


def one_card(entry: str, chips: int) -> None:
    """Refuse a cell of more than one card for the one-card ``entry``."""
    if chips != 1:
        raise ValueError(f"entry {entry!r} runs on one card; the cell asks "
                         f"for {chips}")
