"""Decode attention over a KV cache: the single-shard path of the
reference's ``repro.models.decode.dist_decode``.

The reference shards the cache on its sequence axis over a mesh and
combines each shard's partial softmax with two collectives; with no mesh
it computes the one partial below over the whole cache and normalises it.
The port runs on one device, so that is the whole path here; the
sharded combine waits with the multi-card work (ROADMAP §1 item 1).
"""
from __future__ import annotations

import torch

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
    (global) or a Python int."""
    dk = q.shape[-1]
    scale = scale if scale is not None else dk ** -0.5
    offset = torch.zeros((1, 1, 1), dtype=torch.int32, device=q.device)
    m, l, acc = _partial(q, k_cache, v_cache, kv_len, offset, window, scale)
    return acc / torch.where(l == 0., 1., l)[..., None]
