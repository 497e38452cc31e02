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

**The point axis.** The chunk step runs B design points at once, the JAX
package's ``vmap`` written out as a leading axis: a table is
``[B, n_pages, 8]``, a request vector ``[B, chunk]``, a scalar ``[B]``.
Each helper takes that axis or none; with it, point ``b``'s indices
address point ``b``'s own tensor (a gather reads its own table, a dropped
scatter update lands on its own index 0).
"""
from __future__ import annotations

import functools

import torch


def gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` under JAX's gather rule for an axis of length ``n``, as
    int64 ready for PyTorch indexing."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


@functools.lru_cache(maxsize=None)
def _point_ids(b: int, dims: int, device: torch.device) -> torch.Tensor:
    """``arange(b)`` shaped [b, 1, ...] (``dims`` dims) to index the point
    axis; made once per shape, since the chunk loop indexes every chunk."""
    return torch.arange(b, device=device).view(-1, *(1,) * (dims - 1))


def _rows(x: torch.Tensor, idx: torch.Tensor, points: int) -> tuple:
    """The index tuple of ``x[idx]`` along dim ``points`` (0 or 1), with
    JAX's gather rule; with ``points=1`` the leading axis of ``x`` and
    ``idx`` is the point axis."""
    gi = gather_index(idx, x.shape[points])
    if points == 0:
        return (gi,)
    return (_point_ids(x.shape[0], gi.dim(), x.device), gi)


def take(x: torch.Tensor, idx: torch.Tensor, points: int = 0) -> torch.Tensor:
    """``x[idx]`` along dim ``points`` with JAX's gather rule: dim 0 of a
    shared ``x``, or (``points=1``) dim 1 of a stacked ``x`` [B, n, ...]
    with ``idx`` [B, ...], each point reading its own ``x``."""
    return x[_rows(x, idx, points)]


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a packed table [n_pages, W] or, per point, of a
    stacked one [B, n_pages, W] (``idx`` [B, ...])."""
    return take(table, idx, table.dim() - 2)


def take_lane(table: torch.Tensor, idx: torch.Tensor,
              lane: int) -> torch.Tensor:
    """``table[idx, lane]`` with JAX's gather rule on the row index, per
    point for a stacked table."""
    return take(table[..., lane], idx, table.dim() - 2)


def put_lane_(table: torch.Tensor, idx: torch.Tensor, lane: int,
              value: torch.Tensor) -> torch.Tensor:
    """In place: ``table[idx, lane] = value`` (JAX's gather rule on the
    row index), per point for a stacked table."""
    col = table[..., lane]
    col[_rows(col, idx, table.dim() - 2)] = value
    return table


def scatter_add_drop_(flat: torch.Tensor, idx: torch.Tensor,
                      upd: torch.Tensor) -> torch.Tensor:
    """In place: ``flat.at[idx].add(upd, mode="drop")`` along the last
    axis of ``flat`` [n] or, per point, [B, n] (``idx``, ``upd`` [B, k]).
    Dropped updates become adds of 0 at the point's own index 0, so no
    mask leaves the device."""
    n = flat.shape[-1]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    keep = (idx >= 0) & (idx < n)
    flat.scatter_add_(-1, torch.where(keep, idx, 0),
                      torch.where(keep, upd, torch.zeros_like(upd)))
    return flat

