"""Model assembly for the dense GQA family: init, the full-sequence
forward, prefill and decode (the port's counterpart of
``repro.models.transformer``).

Parameters are stacked over layers (``[L, ...]``, the reference's scan
layout) and the layer scan is a Python loop over that axis. Per-layer
heterogeneity (gemma3's 5:1 local:global interleave) rides through
``layer_windows``: one ``Optional[int]`` a layer, None for a global
layer (the reference's ``NO_WINDOW`` sentinel).

Cache convention: ``pos`` = number of tokens already in the cache. A
decode step writes the new token's state at index ``pos`` and attends
over ``pos + 1`` entries. The port updates the cache in place and
returns it. A lane whose ``pos`` has passed the cache's capacity (an
idle serving lane, which every step still advances) has its write
dropped, as the reference's out-of-range scatter is, with no device
assert and no host synchronisation.

The ``mla``, ``rwkv6`` and ``hymba`` block families and MoE FFNs raise
``NotImplementedError``; training (``loss_fn``) waits for its slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from . import layers
from .config import ModelConfig
from .decode import dist_decode
from .sharding import ShardCtx

# Where the families the port does not run yet are queued.
_QUEUED = {"rwkv6": "ROADMAP §1 item 3.2", "mla": "ROADMAP §1 item 3.3",
           "hymba": "ROADMAP §1 item 3.3"}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.attn_type != "gqa":
        where = _QUEUED.get(cfg.attn_type)
        if where is None:
            raise ValueError(cfg.attn_type)
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.attn_type!r} block family is not ported "
            f"yet ({where})")
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE FFNs are not ported yet (ROADMAP §1 item 3.3)")


def _layer(params: dict, l: int) -> dict:
    """Layer ``l``'s parameters (views into the stacked tensors)."""
    return {blk: {k: v[l] for k, v in p.items()}
            for blk, p in params["layers"].items()}


# --------------------------------------------------------------------------- #
# parameter init
# --------------------------------------------------------------------------- #

def _dense(gen: torch.Generator, shape, dtype, device, scale=0.02):
    """N(0, scale^2) drawn in float32 and cast, one leading slice at a time
    for stacked ``[L, ...]`` weights (a layer's float32 draw at a time)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out if len(shape) == 3 else out[None]
    for row in rows:
        row.copy_(torch.randn(row.shape, generator=gen, device=device,
                              dtype=torch.float32) * scale)
    return out


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> dict:
    """Random parameters in the reference's tree layout, shapes and
    dtypes, drawn from ``gen`` (a ``torch.Generator`` on ``device``).
    ``device``: ``cuda`` unless the caller asks for the CPU."""
    _check_family(cfg)
    device = resolve_device(device)
    dt = cfg.pdtype
    d, hd, L = cfg.d_model, cfg.head_dim_, cfg.n_layers
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    dense = lambda *shape: _dense(gen, shape, dt, device)
    embed = {"tokens": dense(cfg.vocab, d)}
    if cfg.frontend == "frames":
        embed["frames"] = dense(cfg.frame_dim, d)
    params = {
        "embed": embed,
        "layers": {
            "attn": {"norm": ones(L, d),
                     "wq": dense(L, d, cfg.n_heads * hd),
                     "wk": dense(L, d, cfg.n_kv_heads * hd),
                     "wv": dense(L, d, cfg.n_kv_heads * hd),
                     "wo": dense(L, cfg.n_heads * hd, d)},
            "mlp": {"norm": ones(L, d),
                    "w_in": dense(L, d, cfg.d_ff),
                    "w_gate": dense(L, d, cfg.d_ff),
                    "w_out": dense(L, cfg.d_ff, d)},
        },
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, cfg.vocab)
    return params


# --------------------------------------------------------------------------- #
# per-layer windows (local/global interleave)
# --------------------------------------------------------------------------- #

def layer_windows(cfg: ModelConfig) -> Optional[list]:
    """None -> all layers global. Otherwise one entry a layer: the local
    window, or None for a global layer (the reference's ``NO_WINDOW``)."""
    if cfg.window is None:
        return None
    if cfg.attn_type == "hymba":
        glb = [l in cfg.hymba_global_layers for l in range(cfg.n_layers)]
    else:
        glb = [l % cfg.global_every == cfg.global_every - 1
               for l in range(cfg.n_layers)]
    return [None if g else int(cfg.window) for g in glb]


def _windows(cfg: ModelConfig) -> list:
    return layer_windows(cfg) or [None] * cfg.n_layers


# --------------------------------------------------------------------------- #
# full-sequence forward (prefill)
# --------------------------------------------------------------------------- #

def _seq_block(cfg: ModelConfig, sh: ShardCtx, positions, p, x, window):
    """One layer over the full sequence. Returns (x, cache_entry)."""
    h = layers.rms_norm(x, p["attn"]["norm"], cfg.norm_eps)
    a, cache = layers.gqa_attention(cfg, p["attn"], h, sh, positions, window)
    x = x + a
    h2 = layers.rms_norm(x, p["mlp"]["norm"], cfg.norm_eps)
    x = x + layers.swiglu(h2, p["mlp"], sh, cfg.adtype)
    return x, cache


def _embed(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
           sh: ShardCtx, frames_ndim: int) -> torch.Tensor:
    if cfg.frontend == "frames" and inputs.ndim == frames_ndim:
        return layers.embed_frames(cfg, params["embed"], inputs, sh)
    return layers.embed_tokens(cfg, params["embed"], inputs, sh)


@layers.fp32_accumulation
def forward_seq(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
                sh: ShardCtx, *, collect_cache: bool):
    """inputs: int tokens [B,S] or frames [B,S,frame_dim].
    Returns (x_final [B,S,D], stacked cache | None, aux_mean): the cache
    is ``{"k", "v"}`` of ``[L, B, Hkv, S, Dh]``; aux is 0 (no MoE)."""
    _check_family(cfg)
    x = _embed(cfg, params, inputs, sh, frames_ndim=3)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for l, window in enumerate(_windows(cfg)):
        x, kv = _seq_block(cfg, sh, positions, _layer(params, l), x, window)
        if collect_cache:
            ks.append(kv["k"])
            vs.append(kv["v"])
    cache = ({"k": torch.stack(ks), "v": torch.stack(vs)}
             if collect_cache else None)
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


@layers.fp32_accumulation
def prefill(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
            sh: ShardCtx, smax: int):
    """Build a decode cache of capacity ``smax`` from a full prompt.
    Returns (last_logits [B,V], cache, pos int32 [B])."""
    x, cache, _ = forward_seq(cfg, params, inputs, sh, collect_cache=True)
    b, s = x.shape[:2]
    if s > smax:
        raise ValueError(f"prompt of {s} tokens past the cache's {smax}")
    for name in ("k", "v"):
        c = cache[name]
        padded = c.new_zeros((*c.shape[:3], smax, c.shape[4]))
        padded[:, :, :, :s] = c
        cache[name] = padded
    logits = layers.lm_logits(cfg, params, x[:, -1:], sh)[:, 0]
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, cache, pos


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #

def init_cache(cfg: ModelConfig, batch: int, smax: int, device=None):
    """Empty decode cache (capacity smax), stacked over layers:
    ``{"k", "v"}`` of ``[L, B, Hkv, smax, Dh]`` in the activation dtype."""
    _check_family(cfg)
    kv = (cfg.n_layers, batch, cfg.n_kv_heads, smax, cfg.head_dim_)
    device = resolve_device(device)
    return {"k": torch.zeros(kv, dtype=cfg.adtype, device=device),
            "v": torch.zeros(kv, dtype=cfg.adtype, device=device)}


def _write_token(cache: torch.Tensor, bidx: torch.Tensor, pos: torch.Tensor,
                 x: torch.Tensor) -> None:
    """``cache[b, :, pos[b]] = x[b]`` in place, dropped for a lane whose
    ``pos`` is past the capacity: that lane rewrites its last slot with
    the value it holds, so nothing reads or writes out of range."""
    smax = cache.shape[2]
    slot = pos.clamp(max=smax - 1)
    keep = (pos < smax)[:, None, None]
    cache[bidx, :, slot] = torch.where(keep, x, cache[bidx, :, slot])


def _decode_block(cfg: ModelConfig, sh: ShardCtx, p, x, ck, cv, pos,
                  window, cos, sin, bidx):
    """One layer, one token. x [B,1,D]; ck/cv: this layer's cache
    ``[B,Hkv,smax,Dh]``, written in place; cos/sin ``[B,1,1,Dh/2]``, the
    RoPE tables at ``pos``; bidx ``arange(B)``. Returns x."""
    b = x.shape[0]
    hd = cfg.head_dim_
    adtype = cfg.adtype
    h = layers.rms_norm(x, p["attn"]["norm"], cfg.norm_eps)
    k = (h @ p["attn"]["wk"].to(adtype)).reshape(b, cfg.n_kv_heads, hd)
    v = (h @ p["attn"]["wv"].to(adtype)).reshape(b, cfg.n_kv_heads, hd)
    k = layers.apply_rope(k[:, :, None], cos, sin)[:, :, 0]
    posl = pos.long()
    _write_token(ck, bidx, posl, k)
    _write_token(cv, bidx, posl, v)
    q = (h @ p["attn"]["wq"].to(adtype)).reshape(b, cfg.n_heads, hd)
    q = layers.apply_rope(q[:, :, None], cos, sin)[:, :, 0]
    o = dist_decode(q, ck, cv, pos + 1, sh=sh, window=window)
    o = o.to(adtype).reshape(b, 1, cfg.n_heads * hd)
    x = x + o @ p["attn"]["wo"].to(adtype)
    h2 = layers.rms_norm(x, p["mlp"]["norm"], cfg.norm_eps)
    return x + layers.swiglu(h2, p["mlp"], sh, adtype)


@layers.fp32_accumulation
def decode_step(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
                cache: dict, pos: torch.Tensor, sh: ShardCtx):
    """One new token for every sequence in the batch.

    inputs: int [B] token ids (or [B, frame_dim] frames); cache: from
    init_cache/prefill, updated in place; pos: int32 [B] tokens already
    cached. Returns (logits [B,V], cache, pos+1).
    """
    _check_family(cfg)
    x = _embed(cfg, params, inputs[:, None], sh, frames_ndim=3)
    cos, sin = layers.rope_tables(pos.float()[:, None], cfg.head_dim_,
                                  cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]
    bidx = torch.arange(x.shape[0], device=x.device)
    for l, window in enumerate(_windows(cfg)):
        x = _decode_block(cfg, sh, _layer(params, l), x, cache["k"][l],
                          cache["v"][l], pos, window, cos, sin, bidx)
    logits = layers.lm_logits(cfg, params, x, sh)[:, 0]
    return logits, cache, pos + 1
