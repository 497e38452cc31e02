"""Selective SSM (Mamba) head and the Hymba parallel attention + SSM block
(arXiv:2411.13676): the port's counterpart of ``repro.models.mamba``.

Hymba runs attention heads and Mamba heads in parallel on the same
normed input; each path's output is RMS-normalised, the two are averaged
and projected once. Most layers use sliding-window attention; layers
``cfg.hymba_global_layers`` stay global. At decode the local layers' KV
caches are ring buffers of the window (``transformer.hymba_cache_sizes``).

The SSM recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t`` is a
length-S sequential scan over a ``[B, d_inner, N]`` state, as in the
reference. The element-wise work is done for every step at once (the
decays and the inputs, ``[B, S, d_inner, N]``), the loop keeps one fused
multiply-add a step, and ``y`` is contracted with ``C`` after it: the
same arithmetic in far fewer launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers
from .config import ModelConfig
from .decode import dist_decode
from .layers import fp32_accumulation
from .sharding import ShardCtx


def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or max(1, -(-cfg.d_model // 16))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_params(cfg: ModelConfig, p: dict, x_in: torch.Tensor):
    """x_in [B,S,di] (after the conv and SiLU) -> dt fp32 [B,S,di], B and C
    fp32 [B,S,N]."""
    n = cfg.ssm.d_state
    r = _dt_rank(cfg)
    proj = x_in @ p["x_proj"].to(x_in.dtype)
    dt, bmat, cmat = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    dt = dt @ p["dt_proj"].to(x_in.dtype)
    dt = _softplus(dt.float() + p["dt_bias"].float())
    return dt, bmat.float(), cmat.float()


def _conv1d(x: torch.Tensor, w: torch.Tensor, state):
    """Causal depthwise conv. x [B,S,di], w [di,K]; ``state`` [B,K-1,di]
    holds the last K-1 inputs (None: zero history). Returns (out in x's
    dtype, new state)."""
    b, s, di = x.shape
    k = w.shape[1]
    if state is None:
        state = x.new_zeros((b, k - 1, di))
    xp = torch.cat([state, x], dim=1)
    out = torch.zeros((b, s, di), dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s].float() * w[:, i].float()
    new_state = xp[:, s:] if k > 1 else state
    return out.to(x.dtype), new_state


@fp32_accumulation
def mamba_mix(cfg: ModelConfig, p: dict, xn: torch.Tensor, sh: ShardCtx,
              conv_state=None, ssm_state=None):
    """The Mamba path. xn [B,S,D] (normed input) -> (y [B,S,di],
    new_conv_state [B,K-1,di], new_ssm_state fp32 [B,di,N])."""
    adtype = cfg.adtype
    b, s, _ = xn.shape
    n = cfg.ssm.d_state
    xz = xn @ p["in_proj"].to(adtype)
    di = xz.shape[-1] // 2
    x, z = xz[..., :di], xz[..., di:]
    x, new_conv = _conv1d(x, p["conv_w"], conv_state)
    x = F.silu(x.float()).to(adtype)
    dt, bmat, cmat = _ssm_params(cfg, p, x)
    a = -torch.exp(p["a_log"].float())                      # [di,N] < 0
    xf = x.float()
    decay = torch.exp(dt[..., None] * a)                    # [B,S,di,N]
    inp = (dt * xf)[..., None] * bmat[:, :, None, :]        # [B,S,di,N]
    h = (ssm_state if ssm_state is not None else
         torch.zeros((b, di, n), dtype=torch.float32, device=xn.device))
    hs = []
    for t in range(s):
        h = torch.addcmul(inp[:, t], h, decay[:, t])
        hs.append(h)
    y = torch.einsum("bsdn,bsn->bsd", torch.stack(hs, 1), cmat) \
        + xf * p["d_skip"].float()
    y = y.to(adtype) * F.silu(z.float()).to(adtype)
    return y, new_conv, h.clone()


def _path_norm(y: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    yf = y.float()
    yf = yf * torch.rsqrt((yf * yf).mean(dim=-1, keepdim=True) + eps)
    return (yf * w.float()).to(y.dtype)


def _fuse(cfg: ModelConfig, p: dict, attn, ssm_y) -> torch.Tensor:
    fused = (_path_norm(attn, p["attn_out_norm"], cfg.norm_eps)
             + _path_norm(ssm_y, p["ssm_out_norm"], cfg.norm_eps)) * 0.5
    return fused @ p["wo"].to(cfg.adtype)


@fp32_accumulation
def hymba_block(cfg: ModelConfig, p: dict, xn: torch.Tensor, sh: ShardCtx,
                positions: torch.Tensor, window) -> tuple[torch.Tensor,
                                                          dict]:
    """Parallel attention + Mamba on the normed input xn [B,S,D]. Returns
    (out [B,S,D], {k, v [B,Hkv,S,Dh], conv, ssm}). The attention is
    context-parallel where ``layers.use_context_parallel`` holds (Hymba's
    25 heads divide no even model axis); the Mamba path runs whole on
    every model rank."""
    b, s, _ = xn.shape
    hd = cfg.head_dim_
    q, k, v = layers.gqa_project(cfg, p, xn, cfg.adtype)
    cos, sin = layers.rope_tables(positions, hd, cfg.rope_theta)
    q = layers.apply_rope(q, cos, sin)
    k = layers.apply_rope(k, cos, sin)
    attn = layers.attend(cfg, sh, q, k, v, window)
    attn = attn.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
    ssm_y, conv_state, ssm_state = mamba_mix(cfg, p["mamba"], xn, sh)
    out = _fuse(cfg, p, attn, ssm_y)
    return out, {"k": k, "v": v, "conv": conv_state, "ssm": ssm_state}


@fp32_accumulation
def hymba_decode(cfg: ModelConfig, p: dict, xn: torch.Tensor, sh: ShardCtx,
                 cache: dict, kv_len: torch.Tensor, eff_len=None
                 ) -> tuple[torch.Tensor, dict]:
    """One Hymba token. xn [B,1,D]; cache: k/v ring buffers [B,Hkv,size,Dh]
    (the new token already written at slot (kv_len-1) % size), conv
    [B,K-1,di], ssm [B,di,N], whose states are updated in place.
    ``eff_len`` = the valid ring slots (min(kv_len, size)); the ring holds
    the window, so no further window mask applies (keys carry their
    absolute positions' RoPE, and attention does not depend on slot
    order)."""
    b = xn.shape[0]
    hd = cfg.head_dim_
    q = (xn @ p["wq"].to(cfg.adtype)).reshape(b, cfg.n_heads, hd)
    cos, sin = layers.rope_tables((kv_len - 1).float()[:, None], hd,
                                  cfg.rope_theta)
    q = layers.apply_rope(q[:, :, None], cos[:, None], sin[:, None])[:, :, 0]
    attn = dist_decode(q, cache["k"], cache["v"],
                       kv_len if eff_len is None else eff_len, sh=sh)
    attn = attn.to(cfg.adtype).reshape(b, 1, cfg.n_heads * hd)
    ssm_y, new_conv, new_ssm = mamba_mix(
        cfg, p["mamba"], xn, sh, conv_state=cache["conv"],
        ssm_state=cache["ssm"])
    cache["conv"].copy_(new_conv)
    cache["ssm"].copy_(new_ssm)
    return _fuse(cfg, p, attn, ssm_y), cache


@fp32_accumulation
def hymba_write_kv(cfg: ModelConfig, p: dict, xn: torch.Tensor, cache: dict,
                   kv_len: torch.Tensor, slot=None,
                   sh: ShardCtx = ShardCtx()) -> dict:
    """Project the new token's k/v (RoPE at its absolute position
    kv_len - 1) and write them, in place, into ring slot ``slot``
    (default kv_len - 1: a cache that does not wrap). On a cache whose
    slots are split over the model axis, only the rank holding the slot
    writes it."""
    b = xn.shape[0]
    hd = cfg.head_dim_
    adtype = cfg.adtype
    k = (xn @ p["wk"].to(adtype)).reshape(b, cfg.n_kv_heads, hd)
    v = (xn @ p["wv"].to(adtype)).reshape(b, cfg.n_kv_heads, hd)
    cos, sin = layers.rope_tables((kv_len - 1).float()[:, None], hd,
                                  cfg.rope_theta)
    k = layers.apply_rope(k[:, :, None], cos[:, None], sin[:, None])[:, :, 0]
    slot = (kv_len - 1 if slot is None else slot).long()
    slot = sh.cache_slot(slot, cache["k"].shape[2])
    bidx = torch.arange(b, device=xn.device)
    # the caches' slot axis second: [B, size, Hkv, Dh] views
    layers.write_row(cache["k"].transpose(1, 2), bidx, slot, k)
    layers.write_row(cache["v"].transpose(1, 2), bidx, slot, v)
    return cache
