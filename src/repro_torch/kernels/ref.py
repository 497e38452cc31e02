"""Plain PyTorch versions of the HMMU table gather (the port's
counterpart of the HMMU part of ``repro.kernels.ref``)."""
from __future__ import annotations

import torch


def hmmu_lookup(table: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Redirection-table row gather with indices clamped to
    ``[0, n_pages)``. table: int32[*batch, n_pages, W]; pages:
    int32[*batch, m] -> int32[*batch, m, W]."""
    n_pages = table.shape[-2]
    idx = pages.to(torch.int64).clamp(0, n_pages - 1)
    idx = idx[..., None].expand(*pages.shape, table.shape[-1])
    return torch.gather(table, -2, idx)


def fused_gather(lookup, table: torch.Tensor, pages: torch.Tensor,
                 extra: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Append ``extra`` page indices to the chunk's pages, run ONE
    ``lookup(table, pages)`` over the ``m + k`` indices, split the rows
    back into (chunk rows, extra rows)."""
    cat = torch.cat([pages, extra.to(pages.dtype)], dim=-1)
    rows = lookup(table, cat)
    n = pages.shape[-1]
    return rows[..., :n, :], rows[..., n:, :]

