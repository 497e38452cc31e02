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

