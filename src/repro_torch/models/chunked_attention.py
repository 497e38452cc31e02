"""Memory-bounded attention in plain PyTorch with a flash-style backward:
the port of the reference's ``repro.models.chunked_attention``, the
attention path of the model's prefill and training.

GQA/MQA kv heads are handled in *grouped* form: q is viewed as
[B, Hkv, G, S, D] and every product contracts against the unexpanded
[B, Hkv, S, D] k/v; nothing repeats a kv head. The forward loops over
query blocks; each block computes float32 logits against the whole K
(peak memory B*H*bq*S) with a numerically stable softmax, so no S x S
matrix exists beyond one block. A sequence that the block size does not
divide runs as one block, as in the reference.

The backward (the reference's ``custom_vjp``, a ``torch.autograd.
Function`` here) keeps the forward's ``out`` and logsumexp, recomputes P
block by block and carries dK and dV in float32: O(S) residuals, and
again no S x S matrix beyond one query block.

``window`` is None (global) or a Python int: the model's layers carry
``Optional[int]`` windows (``transformer.layer_windows``).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(qi: torch.Tensor, ki: torch.Tensor, causal: bool,
          window) -> torch.Tensor:
    m = torch.ones(torch.broadcast_shapes(qi.shape, ki.shape),
                   dtype=torch.bool, device=qi.device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= qi - ki < window
    return m


def _fwd_blocks(q, k, v, causal, window, scale, block_q):
    """q: [B,Hkv,G,S,D]; k/v: [B,Hkv,Skv,D] -> (out [B,Hkv,G,S,Dv] fp32,
    lse [B,Hkv,G,S])."""
    s = q.shape[3]
    skv = k.shape[2]
    q_off = skv - s
    kf, vf = k.float(), v.float()
    ki = torch.arange(skv, device=q.device)[None, :]
    outs, lses = [], []
    for start in range(0, s, block_q):
        qblk = q[:, :, :, start:start + block_q]
        logits = torch.einsum("bkgqd,bktd->bkgqt", qblk.float(), kf) * scale
        qi = torch.arange(start, start + block_q, device=q.device)[:, None] \
            + q_off
        logits = torch.where(_mask(qi, ki, causal, window), logits, NEG_INF)
        m = logits.amax(dim=-1)
        p = torch.exp(logits - m[..., None])
        l = p.sum(dim=-1)
        o = torch.einsum("bkgqt,bktd->bkgqd", p, vf)
        l1 = torch.where(l == 0., 1., l)
        outs.append(o / l1[..., None])
        lses.append(m + torch.log(l1))
    return torch.cat(outs, dim=3), torch.cat(lses, dim=3)


def _bwd_blocks(q, k, v, out, lse, gr, causal, window, scale, block_q):
    """The reference's ``_bwd_blocks``: (dq, dk, dv) in q's, k's and v's
    dtypes, dK and dV summed over the query blocks in float32."""
    s = q.shape[3]
    skv = k.shape[2]
    q_off = skv - s
    delta = (gr.float() * out.float()).sum(dim=-1)
    kf, vf = k.float(), v.float()
    ki = torch.arange(skv, device=q.device)[None, :]
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=q.device)
    dqs = []
    for start in range(0, s, block_q):
        blk = slice(start, start + block_q)
        qblk = q[:, :, :, blk].float()
        logits = torch.einsum("bkgqd,bktd->bkgqt", qblk, kf) * scale
        qi = torch.arange(start, start + block_q, device=q.device)[:, None] \
            + q_off
        logits = torch.where(_mask(qi, ki, causal, window), logits, NEG_INF)
        p = torch.exp(logits - lse[:, :, :, blk, None])
        gf = gr[:, :, :, blk].float()
        dp = torch.einsum("bkgqd,bktd->bkgqt", gf, vf)
        ds = p * (dp - delta[:, :, :, blk, None]) * scale
        dqs.append(torch.einsum("bkgqt,bktd->bkgqd", ds, kf))
        dk = dk + torch.einsum("bkgqt,bkgqd->bktd", ds, qblk)
        dv = dv + torch.einsum("bkgqt,bkgqd->bktd", p, gf)
    return (torch.cat(dqs, dim=3).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Chunked(torch.autograd.Function):
    """The reference's ``custom_vjp``: the blocked forward, saving ``out``
    (float32) and the logsumexp, and the blocked backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, block_q):
        out, lse = _fwd_blocks(q, k, v, causal, window, scale, block_q)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, block_q)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_blocks(q, k, v, out, lse, g, *ctx.args)
        return dq, dk, dv, None, None, None, None


def naive_attention(q, k, v, *, causal=True, window=None, scale=None,
                    q_offset=None):
    """Single-shot attention (identical math, S x S logits materialized):
    the reference's cost-extraction variant (``attention_impl="naive"``)
    and its context-parallel form. ``q_offset`` is the position of q's
    first row among k's (default: q is the tail of k)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    if q_offset is None:
        q_offset = skv - sq
    qg = q.reshape(b, hkv, g, sq, d)
    logits = torch.einsum("bkgqd,bktd->bkgqt", qg.float(), k.float()) * scale
    qi = torch.arange(sq, device=q.device)[:, None] + q_offset
    ki = torch.arange(skv, device=q.device)[None, :]
    logits = torch.where(_mask(qi, ki, causal, window), logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=None, scale=None,
                      block_q=1024):
    """q:[B,Hq,Sq,D]; k,v:[B,Hkv,Skv,D] -> [B,Hq,Sq,Dv] in q's dtype.

    GQA kv heads are contracted in grouped form (never expanded).
    """
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    block_q = min(block_q, sq)
    if sq % block_q:                     # ragged tail: fall back to one block
        block_q = sq
    qg = q.reshape(b, hkv, g, sq, d)
    out = _Chunked.apply(qg, k, v, causal, window, scale, block_q)
    return out.reshape(b, hq, sq, v.shape[-1])
