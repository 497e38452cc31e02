"""The comparison that decides ``correct``: the program's answer against
the plain reference's, exactly.

A record is a dict with ``outs`` (each per-request output, [B, n]),
``state`` (every field of the final state by dotted name, [B, ...]; the
counters under ``counters.``) and ``readout`` (what the user reads: one
dict a design point). The emulator's pipeline is exact int32 and its
float32 counters are specified bit for bit, so every number compared is
a count of values that differ, with the limit 0.
"""
from __future__ import annotations

import math

import torch

# name -> limit. A count of values that differ from the reference's.
LIMITS = {"outs_differ": 0, "state_differ": 0, "counters_differ": 0,
          "answer_differ": 0}


def _differ(a: torch.Tensor | None, b: torch.Tensor | None) -> int:
    """Values of ``a`` and ``b`` that are not bitwise equal; every value
    of the larger when the shapes or dtypes disagree or one is missing."""
    if a is None or b is None:
        return max(0 if a is None else a.numel(),
                   0 if b is None else b.numel(), 1)
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel(), 1)
    return int((_bits(a) != _bits(b)).sum())


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor as its bit patterns (so -0.0 differs from 0.0 and a
    NaN equals itself); any other tensor as it is."""
    if not t.dtype.is_floating_point:
        return t
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(ints[t.element_size()])


def _same(x, y) -> bool:
    if isinstance(x, float) and isinstance(y, float):
        return x == y or (math.isnan(x) and math.isnan(y))
    return type(x) is type(y) and x == y


def _count(got: dict, want: dict) -> int:
    return sum(_differ(got.get(k), want.get(k)) for k in set(got) | set(want))


def compare(got: dict, want: dict) -> dict:
    """{number: count} of ``got``'s values that differ from ``want``'s."""
    split = lambda d, ctr: {k: v for k, v in d.items()
                            if k.startswith("counters.") == ctr}
    answer = abs(len(got["readout"]) - len(want["readout"]))
    for g, w in zip(got["readout"], want["readout"]):
        answer += sum(not _same(g.get(k), w.get(k)) for k in set(g) | set(w))
    return {"outs_differ": _count(got["outs"], want["outs"]),
            "state_differ": _count(split(got["state"], False),
                                   split(want["state"], False)),
            "counters_differ": _count(split(got["state"], True),
                                      split(want["state"], True)),
            "answer_differ": answer}


def verdict(numbers: dict) -> bool:
    """Every number within its limit."""
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
