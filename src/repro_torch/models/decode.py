"""Distributed flash-decode: partial softmax over a KV cache and, on a
mesh, the combine over a cache split on its sequence axis (the port's
counterpart of ``repro.models.decode``).

Decode caches are split on their *sequence* axis over ``"model"``: each
model rank holds rows ``[r Smax/tp, (r+1) Smax/tp)`` and computes a
partial (max, sum, weighted accumulator) over them; the combine is three
small collectives (``dist``):

    m* = max(m);  l* = sum(l e^{m - m*});  acc* = sum(acc e^{m - m*})

With no mesh the one partial covers the whole cache and is normalised.
"""
from __future__ import annotations

import torch

from .. import dist
from .sharding import ShardCtx

NEG_INF = -1e30


def _partial(q, k, v, kv_len, offset, window, scale):
    """Local partial softmax. q:[B,H,Dk]; k:[B,Hkv,Sl,Dk]; v:[B,Hkv,Sl,Dv];
    offset: int32 [1,1,1] (the slice's first position).
    Returns m:[B,H], l:[B,H], acc:[B,H,Dv].

    Grouped-GQA products: kv heads are never expanded to query heads."""
    b, hq, dk = q.shape
    hkv, sl = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, dk)
    logits = torch.einsum("bkgd,bktd->bkgt", qg.float(), k.float()) * scale
    pos = offset[..., None, :] + torch.arange(
        sl, device=q.device)[None, None, None, :]
    n = kv_len[:, None, None, None]
    mask = pos < n
    if window is not None:
        mask &= pos >= n - window
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    dv = v.shape[-1]
    return m.reshape(b, hq), l.reshape(b, hq), acc.reshape(b, hq, dv)


def dist_decode(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                sh: ShardCtx, window=None,
                scale: float | None = None) -> torch.Tensor:
    """q:[B,Hq,Dk]; k_cache:[B,Hkv,Smax,Dk]; v_cache:[B,Hkv,Smax,Dv];
    kv_len:int[B] -> [B,Hq,Dv] (fp32, caller casts). ``window`` is None
    (global) or a Python int. On a mesh with a model axis the caches are
    this rank's sequence slice (``Smax`` rows of ``Smax * tp``), starting
    at global row ``r * Smax``."""
    dk = q.shape[-1]
    scale = scale if scale is not None else dk ** -0.5
    sl = k_cache.shape[2]
    off = sh.coord("model") * sl if sh.seq_shards > 1 else 0
    offset = torch.full((1, 1, 1), off, dtype=torch.int32, device=q.device)
    m, l, acc = _partial(q, k_cache, v_cache, kv_len, offset, window, scale)
    if sh.seq_shards > 1:
        m_g = dist.all_reduce(m, sh, "model", op="max")
        corr = torch.exp(m - m_g)
        l = dist.all_reduce(l * corr, sh, "model")
        acc = dist.all_reduce(acc * corr[..., None], sh, "model")
    return acc / torch.where(l == 0., 1., l)[..., None]
