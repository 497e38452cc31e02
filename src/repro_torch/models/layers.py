"""Shared transformer layers: norms, RoPE, SwiGLU, GQA attention (the
port's counterpart of ``repro.models.layers``).

All functions are pure; parameters are dicts of tensors created by
``transformer.init_params``. Activations take ``cfg.adtype``; norms, RoPE,
the SwiGLU gate, softmax and the loss compute in float32 and cast back
at the reference's points. A product of two bfloat16 tensors gives
bfloat16 with float32 accumulation, as the reference's ``einsum`` does:
every function here and in ``transformer`` that takes a product runs
under ``fp32_accumulation``.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

from .. import dist
from .chunked_attention import chunked_attention, naive_attention
from .config import ModelConfig
from .sharding import ShardCtx


@contextlib.contextmanager
def fp32_sums():
    """Inside, cuBLAS's reduced-precision reduction of bfloat16 products is
    switched off; the caller's setting is restored on leaving. PyTorch's
    default (``torch.backends.cuda.matmul.
    allow_bf16_reduced_precision_reduction``) lets cuBLAS sum a split-K
    product's partials in bfloat16; the reference accumulates in float32.
    The switch is process-wide: a product another thread runs meanwhile
    accumulates in float32 too."""
    mm = torch.backends.cuda.matmul
    saved = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_bf16_reduced_precision_reduction = saved


def fp32_accumulation(fn):
    """Run ``fn`` under ``fp32_sums``. Its backward runs after ``fn`` has
    returned, outside: a training step runs its forward and backward
    inside ``fp32_sums`` (``launch.steps.make_train_step``)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with fp32_sums():
            return fn(*args, **kwargs)
    return run


def write_row(cache: torch.Tensor, bidx: torch.Tensor, pos: torch.Tensor,
              x: torch.Tensor) -> None:
    """``cache[b, pos[b]] = x[b]`` in place for a ``[B, smax, ...]`` cache
    (or a view of one with the position axis second), dropped for a lane
    whose ``pos`` is past the capacity: that lane rewrites its last row
    with the value it holds, so nothing reads or writes out of range."""
    smax = cache.shape[1]
    slot = pos.clamp(max=smax - 1)
    keep = (pos < smax).reshape(-1, *[1] * (x.dim() - 1))
    cache[bidx, slot] = torch.where(keep, x, cache[bidx, slot])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...,] -> (cos, sin) of shape [..., dim/2]."""
    exps = -torch.arange(0, dim, 2, dtype=torch.float32,
                         device=positions.device) / dim
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., S, D]; cos/sin [S, D/2] (broadcastable)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@fp32_accumulation
def swiglu(x: torch.Tensor, p: dict, sh: ShardCtx, adtype) -> torch.Tensor:
    h = x @ p["w_in"].to(adtype)
    g = x @ p["w_gate"].to(adtype)
    h = F.silu(g.float()).to(adtype) * h
    return h @ p["w_out"].to(adtype)


@fp32_accumulation
def gqa_project(cfg: ModelConfig, p: dict, x: torch.Tensor, adtype):
    """x [B,S,D] -> q [B,Hq,S,Dh], k/v [B,Hkv,S,Dh]."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = x @ p["wq"].to(adtype)
    k = x @ p["wk"].to(adtype)
    v = x @ p["wv"].to(adtype)
    q = q.reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    return q, k, v


def use_context_parallel(cfg: ModelConfig, sh: ShardCtx, b: int, s: int,
                         budget_bytes: float = 4e9) -> bool:
    """The reference's predicate for context-parallel attention: head
    counts that do not divide the model axis (musicgen 24, gemma3 8,
    hymba 25) split the *queries* on the sequence axis instead, when a
    rank's logits ``[b_loc, H, S/tp, S]`` in float32 fit
    ``budget_bytes``. On a mesh ``b`` is the rank's own rows, ``b_loc``;
    without one it is the global batch, whose share of the batch axes
    ``b_loc`` is where they divide it, as in the reference."""
    if not (sh.model_axis is not None and not sh.divides(cfg.n_heads)
            and s % sh.size("model") == 0 and s > 1):
        return False
    dp = sh.batch_size
    b_loc = b if sh.mesh is not None or b % dp else b / dp
    logits = b_loc * cfg.n_heads * (s / sh.size("model")) * s * 4.0
    return logits <= budget_bytes


def attention_seq_sharded(cfg: ModelConfig, sh: ShardCtx, q, k, v, window,
                          scale=None):
    """Context-parallel attention, the reference's single-shot form: each
    model rank takes its query rows ``[r S/tp, (r+1) S/tp)`` against the
    whole K/V (naive attention, logits ``[B, H, S/tp, S]``; the causal and
    window masks at the rows' global positions) and the ranks' outputs
    are all-gathered on the sequence axis (with their gradient). Without
    a mesh, every row at once."""
    if sh.mesh is None:
        return naive_attention(q, k, v, causal=True, window=window,
                               scale=scale)
    rows = q.shape[2] // sh.size("model")
    lo = sh.coord("model") * rows
    o = naive_attention(q[:, :, lo:lo + rows], k, v, causal=True,
                        window=window, scale=scale, q_offset=lo)
    return dist.all_gather(o, 2, sh)


@fp32_accumulation
def gqa_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, sh: ShardCtx,
                  positions: torch.Tensor, window) -> tuple[torch.Tensor,
                                                            dict]:
    """Full-sequence GQA attention (prefill and training). Returns (out,
    kv); context-parallel where ``use_context_parallel`` holds."""
    adtype = cfg.adtype
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q, k, v = gqa_project(cfg, p, x, adtype)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attend(cfg, sh, q, k, v, window)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
    out = o @ p["wo"].to(adtype)
    return out, {"k": k, "v": v}


def attend(cfg: ModelConfig, sh: ShardCtx, q, k, v, window):
    """Causal (windowed) attention of [B, H, S, D] q over its k/v: the
    context-parallel form where ``use_context_parallel`` holds, else the
    configured one (``chunked`` or ``naive``)."""
    if use_context_parallel(cfg, sh, q.shape[0], q.shape[2]):
        return attention_seq_sharded(cfg, sh, q, k, v, window)
    attn_fn = (naive_attention if cfg.attention_impl == "naive"
               else chunked_attention)
    return attn_fn(q, k, v, causal=True, window=window)


def embed_tokens(cfg: ModelConfig, p: dict, tokens: torch.Tensor,
                 sh: ShardCtx) -> torch.Tensor:
    """Token ids [B,S] -> [B,S,D] (the rows gathered, then cast: the
    reference's cast of the whole table, then the gather, element for
    element)."""
    return p["tokens"][tokens.long()].to(cfg.adtype)


@fp32_accumulation
def embed_frames(cfg: ModelConfig, p: dict, frames: torch.Tensor,
                 sh: ShardCtx) -> torch.Tensor:
    """Precomputed modality embeddings [B,S,frame_dim] -> [B,S,D] (the
    learned adapter projection of the stub frontend)."""
    return frames.to(cfg.adtype) @ p["frames"].to(cfg.adtype)


@fp32_accumulation
def lm_logits(cfg: ModelConfig, params: dict, x: torch.Tensor,
              sh: ShardCtx) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = (params["embed"]["tokens"].T if cfg.tie_embeddings
            else params["lm_head"])
    return x @ head.to(cfg.adtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token CE. logits [B,S,V] (any dtype), labels int [B,S]."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()
