"""Memory-consistency tag matching (paper §III-C, Fig 3), PyTorch port of
``repro.core.consistency``: a response is held until every earlier one
has been released, so ``return_i = max_{j <= i} complete_j``."""
from __future__ import annotations

import torch


def in_order_returns(complete: torch.Tensor,
                     last_return: torch.Tensor) -> torch.Tensor:
    """Map out-of-order completion times (int32 [..., chunk], request
    order) to in-order return times; ``last_return`` [...] is the previous
    chunk's last return (the FIFO never reorders across chunks either)."""
    shifted = torch.maximum(complete, last_return[..., None])
    return torch.cummax(shifted, dim=-1).values


def reorder_depth(complete: torch.Tensor) -> torch.Tensor:
    """Diagnostic: how many responses had to wait behind an earlier one
    (0 == every one was already in order): an int32 0-dim count over
    every leading axis too, as the reference sums it."""
    ret = torch.cummax(complete, dim=-1).values
    return (ret > complete).sum(dtype=torch.int32)
