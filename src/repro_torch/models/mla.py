"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434): the port's
counterpart of ``repro.models.mla``.

The KV state is a small latent (``kv_lora_rank`` channels, normed) plus
``rope_head_dim`` shared RoPE channels a position. Prefill materialises
per-head K and V from the latent and runs the model's plain attention
(``chunked_attention``); decode uses the *absorbed* form: each head's
query is mapped into latent space (``q_nope @ W_uk^T``), so attention
runs over the cached latents as one headless "kv head"
(``dist_decode``).

The cache is ``{"c_kv": [B, smax, R], "k_rope": [B, smax, rope]}`` a
layer. ``mla_write_cache`` writes the new token at ``kv_len - 1`` in
place; a lane whose ``kv_len - 1`` has passed ``smax`` (an idle serving
lane) has its write dropped, as the reference's out-of-range scatter is,
with no device assert.
"""
from __future__ import annotations

import torch

from . import layers
from .chunked_attention import chunked_attention, naive_attention
from .config import ModelConfig
from .decode import dist_decode
from .layers import fp32_accumulation, write_row
from .sharding import ShardCtx


def _project_q(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x [B,S,D] -> q_nope [B,H,S,nope], q_rope [B,H,S,rope]."""
    m = cfg.mla
    adtype = cfg.adtype
    b, s, _ = x.shape
    cq = x @ p["wq_a"].to(adtype)
    cq = layers.rms_norm(cq, p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wq_b"].to(adtype)).reshape(
        b, s, cfg.n_heads, m.nope_head_dim + m.rope_head_dim).transpose(1, 2)
    return q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]


def _project_kv_latent(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x [B,S,D] -> c_kv [B,S,R] (normed), k_rope [B,1,S,rope] (before
    RoPE)."""
    m = cfg.mla
    ckr = x @ p["wkv_a"].to(cfg.adtype)
    c_kv, k_rope = ckr[..., :m.kv_lora_rank], ckr[..., m.kv_lora_rank:]
    c_kv = layers.rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    return c_kv, k_rope[:, None]


def scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    return (m.nope_head_dim + m.rope_head_dim) ** -0.5


@fp32_accumulation
def mla_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, sh: ShardCtx,
                  positions: torch.Tensor, window) -> tuple[torch.Tensor,
                                                            dict]:
    """The prefill path (per-head K/V materialised). Returns (out
    [B,S,D], {"c_kv" [B,S,R], "k_rope" [B,S,rope] after RoPE})."""
    m = cfg.mla
    adtype = cfg.adtype
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _project_q(cfg, p, x)
    c_kv, k_rope = _project_kv_latent(cfg, p, x)
    cos, sin = layers.rope_tables(positions, m.rope_head_dim, cfg.rope_theta)
    q_rope = layers.apply_rope(q_rope, cos, sin)
    k_rope = layers.apply_rope(k_rope, cos, sin)
    k_nope = torch.einsum("bsr,rhn->bhsn", c_kv, p["wk_b"].to(adtype)
                          .reshape(m.kv_lora_rank, h, m.nope_head_dim))
    v = torch.einsum("bsr,rhn->bhsn", c_kv, p["wv_b"].to(adtype)
                     .reshape(m.kv_lora_rank, h, m.v_head_dim))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, h, s, m.rope_head_dim)], dim=-1)
    attn_fn = (naive_attention if cfg.attention_impl == "naive"
               else chunked_attention)
    o = attn_fn(q, k, v, causal=True, window=window, scale=scale(cfg))
    o = o.transpose(1, 2).reshape(b, s, h * m.v_head_dim)
    out = o @ p["wo"].to(adtype)
    return out, {"c_kv": c_kv, "k_rope": k_rope[:, 0]}


@fp32_accumulation
def mla_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, sh: ShardCtx,
               cache: dict, kv_len: torch.Tensor) -> tuple[torch.Tensor,
                                                           dict]:
    """Absorbed decode. x [B,1,D]; cache {c_kv [B,Smax,R], k_rope
    [B,Smax,rope]} with the new token already written at kv_len - 1."""
    m = cfg.mla
    adtype = cfg.adtype
    b = x.shape[0]
    h = cfg.n_heads
    q_nope, q_rope = _project_q(cfg, p, x)                  # [B,H,1,*]
    cos, sin = layers.rope_tables((kv_len - 1).float()[:, None],
                                  m.rope_head_dim, cfg.rope_theta)
    q_rope = layers.apply_rope(q_rope, cos[:, None], sin[:, None])
    # Absorb W_uk into the query: q_lat = q_nope @ W_uk^T a head.
    wk = p["wk_b"].to(adtype).reshape(m.kv_lora_rank, h, m.nope_head_dim)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, :, 0], wk)
    q_cat = torch.cat([q_lat, q_rope[:, :, 0]], dim=-1)    # [B,H,R+rope]
    k_cat = torch.cat([cache["c_kv"], cache["k_rope"]], dim=-1)
    ctx = dist_decode(q_cat, k_cat[:, None], cache["c_kv"][:, None],
                      kv_len, sh=sh, scale=scale(cfg))      # [B,H,R] fp32
    wv = p["wv_b"].to(adtype).reshape(m.kv_lora_rank, h, m.v_head_dim)
    o = torch.einsum("bhr,rhn->bhn", ctx.to(adtype), wv)
    out = o.reshape(b, 1, h * m.v_head_dim) @ p["wo"].to(adtype)
    return out, cache


@fp32_accumulation
def mla_write_cache(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                    kv_len: torch.Tensor, sh: ShardCtx = ShardCtx()) -> dict:
    """Project the new token's latent and write it at ``kv_len - 1``, in
    place. x [B,1,D]. On a cache split over the model axis only the rank
    holding that row writes it."""
    m = cfg.mla
    c_kv, k_rope = _project_kv_latent(cfg, p, x)     # [B,1,R], [B,1,1,rope]
    pos = kv_len.long() - 1
    cos, sin = layers.rope_tables(pos.float()[:, None], m.rope_head_dim,
                                  cfg.rope_theta)
    k_rope = layers.apply_rope(k_rope[:, 0], cos, sin)      # [B,1,rope]
    pos = sh.cache_slot(pos, cache["c_kv"].shape[1])
    bidx = torch.arange(x.shape[0], device=x.device)
    write_row(cache["c_kv"], bidx, pos, c_kv[:, 0])
    write_row(cache["k_rope"], bidx, pos, k_rope[:, 0])
    return cache
