"""Int8 gradient compression with per-block scales (the port of
``repro.optim.compress``): the wire format of the reference's cross-pod
gradient reduction. Deterministic rounding is round half to even, as
``jnp.round``; stochastic rounding (unbiased) draws from an explicit
``torch.Generator``."""
from __future__ import annotations

import torch

BLOCK = 256


def compress_int8(x: torch.Tensor, gen: torch.Generator | None = None):
    """x (any shape, float) -> (q int8 [N], scale float32 [N/BLOCK],
    meta). ``gen``: stochastic rounding, its uniforms drawn on the
    generator's device."""
    shape = tuple(x.shape)
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    pad = (-n) % BLOCK
    blocks = torch.cat([flat, flat.new_zeros(pad)]).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    y = blocks / scale
    if gen is not None:
        u = torch.rand(y.shape, generator=gen, device=gen.device)
        y = torch.floor(y + u.to(y.device))
    else:
        y = torch.round(y)
    q = torch.clamp(y, -127, 127).to(torch.int8)
    return q, scale[:, 0], (shape, n)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, meta
                    ) -> torch.Tensor:
    shape, n = meta
    flat = (q.float() * scale[:, None]).reshape(-1)[:n]
    return flat.reshape(shape)
