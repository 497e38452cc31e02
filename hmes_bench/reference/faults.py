"""Deterministic fault injection (PyTorch port of ``repro.core.faults``).

A :class:`FaultPlan` holds two int32 event tables keyed on the absolute
``chunk_idx`` of the carried emulator state:

``transient``  int32[nt, 2] rows of (chunk, page): every access to
               ``page`` within that chunk completes but is marked
               ``injected``; no table effect. ``chunk = -1`` rows pad.
``deaths``     int32[nd, 2] rows of (chunk, page), sorted by chunk: the
               frame under ``page`` dies at the first boundary at or after
               ``chunk`` whose rescue register is free. ``chunk = NEVER``
               rows pad.

An empty plan is one sentinel row per class and injects nothing.
``seeded_plan`` draws with numpy's ``default_rng`` exactly as the JAX
package does, so the same seed gives the same plan in both.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .indexing import take

NEVER = 2 ** 30


class FaultPlan(NamedTuple):
    transient: torch.Tensor  # int32[nt, 2] (chunk, page); chunk=-1 padding
    deaths: torch.Tensor     # int32[nd, 2] (chunk, page); chunk=NEVER pad

    @staticmethod
    def empty(device=None) -> "FaultPlan":
        return FaultPlan.of(device=device)

    @staticmethod
    def of(transient=(), deaths=(), device=None) -> "FaultPlan":
        """Build a plan from explicit (chunk, page) event lists. Deaths
        are sorted by chunk; empty classes get one sentinel row."""
        return FaultPlan(
            transient=_rows(transient, -1, device),
            deaths=_rows(sorted(map(tuple, deaths)), NEVER, device))

    def to(self, device) -> "FaultPlan":
        return FaultPlan(self.transient.to(device), self.deaths.to(device))

    @property
    def shape_sig(self) -> tuple:
        """The event tables' shapes (plans stacked together must agree)."""
        return (tuple(self.transient.shape), tuple(self.deaths.shape))

    @property
    def is_batched(self) -> bool:
        """True for a stacked per-design-point plan (:func:`stack_plans`)."""
        return self.transient.dim() == 3


def injected(plan: FaultPlan, page: torch.Tensor,
             chunk_idx: torch.Tensor) -> torch.Tensor:
    """bool[..., n]: the chunk's requests that a transient event marks
    (its page, in this chunk). ``page`` [n] with a 0-dim ``chunk_idx``
    for one point, or [B, n] with [B] for B points; the plan is shared
    by every point or stacked ([B, nt, 2])."""
    tc, tp = plan.transient[..., 0], plan.transient[..., 1]
    return ((page[..., :, None] == tp[..., None, :]) &
            (tc[..., None, :] == chunk_idx[..., None, None])).any(dim=-1)


def next_death(plan: FaultPlan, cursor: torch.Tensor) -> torch.Tensor:
    """int32[..., 2]: the (chunk, page) death event at each point's cursor
    (clamped to the last row; the caller checks ``cursor < nd``), from a
    shared plan or, per point, from a stacked one."""
    nd = plan.deaths.shape[-2]
    return take(plan.deaths, cursor.clamp_max(nd - 1),
                plan.deaths.dim() - 2)


__all__ = ["FaultPlan", "NEVER", "seeded_plan", "stack_plans", "pad_plan",
           "injected", "next_death"]


def _rows(events, sentinel_chunk: int, device) -> torch.Tensor:
    rows = np.asarray(list(events), np.int32).reshape(-1, 2)
    if rows.shape[0] == 0:
        rows = np.asarray([[sentinel_chunk, 0]], np.int32)
    return torch.as_tensor(rows, device=device)
