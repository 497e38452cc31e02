"""Int8 gradient compression with per-block scales (the port of
``repro.optim.compress``): the wire format of the reference's cross-pod
gradient reduction. Deterministic rounding is round half to even, as
``jnp.round``; stochastic rounding (unbiased) draws from an explicit
``torch.Generator``. ``compressed_psum_spec`` is the reduction itself on
a ``torch.distributed`` mesh; as in the reference, the training launcher
does not call it."""
from __future__ import annotations

import torch

from .. import dist
from ..tree import tree_map

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
    # a divisor on the blocks' device: a Python number would become a
    # product by its reciprocal on CUDA, one ulp from the CPU's quotient
    scale = blocks.abs().amax(dim=1, keepdim=True) / blocks.new_tensor(127.0)
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


def compressed_psum_spec(grads, sh, axis: str,
                         gen: torch.Generator | None = None):
    """``grads`` (a tree) summed over the ranks of ``axis`` of ``sh``'s mesh
    with int8 on the wire: each leaf compressed (stochastic rounding from
    ``gen``, the leaves drawing in turn; ``None``: deterministic), its int8
    blocks and float32 scales all-gathered over ``axis``, and each rank's
    blocks dequantised by that rank's scales and summed. Every rank
    returns the same float32 tree."""
    def one(g):
        q, scale, (shape, n) = compress_int8(g, gen)
        qs = dist.all_gather(q[None], 0, sh, axis)
        ss = dist.all_gather(scale[None], 0, sh, axis)
        summed = torch.sum(qs.float() * ss[..., None], dim=0)
        return summed.reshape(-1)[:n].reshape(shape)
    return tree_map(one, grads)
