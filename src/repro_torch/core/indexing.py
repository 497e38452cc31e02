"""Gathers and scatters with the JAX package's out-of-range rules.

PyTorch raises on an out-of-range index (and a CUDA kernel would read
garbage), while the JAX reference never does:

* a **gather** (``x[idx]``) first wraps a negative index once
  (``idx + n``), then clamps it to ``[0, n)``;
* a **scatter** with ``mode="drop"`` (``x.at[idx].add(v, mode="drop")``)
  wraps a negative index once and drops any update whose index is still
  outside ``[0, n)``.

Every trace- or table-derived index of the port goes through these
helpers, so the port agrees with the reference bit for bit even on an
adversarial table. The helpers launch no host synchronisation.
"""
from __future__ import annotations

import torch


def gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` under JAX's gather rule for an axis of length ``n``, as
    int64 ready for PyTorch indexing."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0 with JAX's gather rule."""
    return x[gather_index(idx, x.shape[0])]


def take_lane(table: torch.Tensor, idx: torch.Tensor,
              lane: int) -> torch.Tensor:
    """``table[idx, lane]`` with JAX's gather rule on the row index."""
    return table[gather_index(idx, table.shape[0]), lane]


def scatter_add_drop_(flat: torch.Tensor, idx: torch.Tensor,
                      upd: torch.Tensor) -> torch.Tensor:
    """In place: ``flat.at[idx].add(upd, mode="drop")`` on a 1-D tensor.
    Dropped updates become adds of 0 at index 0, so no mask leaves the
    device."""
    n = flat.shape[0]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    keep = (idx >= 0) & (idx < n)
    flat.index_add_(0, torch.where(keep, idx, 0),
                    torch.where(keep, upd, torch.zeros_like(upd)))
    return flat
