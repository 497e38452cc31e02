"""The plain reference the benchmark holds each answer to.

A frozen copy, in plain PyTorch, of the emulator's chunk-step semantics
(the pipeline, the boundary commit, frame retirement, the six built-in
policies, the DMA engine and the counters) and of what a user reads of
an answer. It imports nothing of the program under test: it takes the
configuration, the grid and the trace that the harness hands to both
sides, and works the platform, the initial state and the packed table
out again itself.

:func:`answer` gives the record that :mod:`hmes_bench.judge` compares;
with ``control=True`` also the control's: the same run with the float32
counters folded in bfloat16, the nearest precision below the one the
configuration states.
"""
from __future__ import annotations

import torch

from . import counters as counters_lib
from .emulator import Trace, emulate
from .points import expand, platform, stacked
from .readout import rows, summary

__all__ = ["answer"]


def _flat(x, prefix: str = "") -> dict:
    """Every tensor of a nested NamedTuple by its dotted field path."""
    out = {}
    for name, v in zip(x._fields, x):
        if isinstance(v, tuple):
            out.update(_flat(v, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = v
    return out


def _lowp_fold():
    """A counter fold that also keeps every point's counters with the
    float fields accumulated in bfloat16: returns (update, read)."""
    held = {}

    def update(p, c, **kw):
        new = counters_lib.update(p, c, **kw)
        zero = counters_lib.Counters(*(torch.zeros_like(x) for x in c))
        chunk = counters_lib.update(p, zero, **kw)
        prev = held.get("c", zero)
        held["c"] = counters_lib.Counters(**{
            f: (prev_f.to(torch.bfloat16) + ch.to(torch.bfloat16))
            .to(torch.float32) if f in counters_lib.FLOAT_FIELDS
            else new_f
            for f, prev_f, ch, new_f in zip(c._fields, prev, chunk, new)})
        return new

    return update, lambda: held["c"]


def _record(points, state, outs, n: int, grid) -> dict:
    """The host-side record of one answer: outputs [B, n], every state
    field [B, ...] by name, and the readout."""
    if grid:
        readout = rows(points, state)
    else:
        readout = [summary(counters_lib.Counters(
            *(x[0] for x in state.counters)))]
    return {"outs": {k: v[:, :n].cpu() for k, v in outs.items()},
            "state": {k: v.cpu() for k, v in _flat(state).items()},
            "readout": readout}


def answer(config: dict, grid: dict | None, trace, device,
           control: bool = False):
    """The reference's record of the answer to ``trace`` (page, offset,
    is_write, size) for the configuration's design point, or for every
    point of ``grid``; with ``control``, (record, control's record)."""
    points = expand(platform(config["platform"]), grid)
    cfg = points[0][1]
    registry, params = stacked(points, device)
    t = Trace(*(x.to(device) for x in trace))
    update, lowp = (_lowp_fold() if control
                    else (counters_lib.update, None))
    with torch.no_grad():
        state, outs = emulate(cfg, registry, t, params, update=update)
    rec = _record(points, state, outs, len(t), grid)
    if not control:
        return rec
    low = _record(points, state._replace(counters=lowp()), outs, len(t),
                  grid)
    return rec, low
