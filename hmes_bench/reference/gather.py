"""The stage-2 redirection-table row gather, in plain PyTorch (the
program launches a CUDA kernel for it on the card)."""
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


def hmmu_lookup_fused(table: torch.Tensor, pages: torch.Tensor,
                      page_a: torch.Tensor, page_b: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunk's rows and the rows of the DMA swap pair from the raw
    registers ``page_a`` and ``page_b`` (int32[*batch]; -1 when idle reads
    row 0) in one gather -> (int32[*batch, m, W], int32[*batch, 2, W])."""
    extra = torch.stack([page_a, page_b], dim=-1).to(pages.dtype)
    rows = hmmu_lookup(table, torch.cat([pages, extra], dim=-1))
    n = pages.shape[-1]
    return rows[..., :n, :], rows[..., n:, :]
