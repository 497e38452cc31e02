"""Model configuration covering every assigned architecture family (the
port's counterpart of ``repro.models.config``).

One dataclass describes dense GQA transformers, MoE (standard and
MLA/DeepSeek-style), RWKV6, hybrid attention+SSM (Hymba), sliding-window
interleaves (Gemma3), and modality-stub backbones (Phi-3-vision,
MusicGen). The fields and ``n_params`` are the reference's; ``pdtype``
and ``adtype`` are torch dtypes. The port's model runs every family
(``transformer.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # always-on shared experts (DeepSeek-V2)
    d_ff_shared: int = 0         # width of the shared expert(s)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0             # 0 -> ceil(d_model / 16)
    expand: int = 1              # d_inner = expand * attn-width


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int                 # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # Block type: "gqa" | "mla" | "rwkv6" | "hymba"
    attn_type: str = "gqa"
    # Sliding-window interleave: None -> all global. Otherwise layers are
    # local (windowed) except every ``global_every``-th (gemma3: 5:1).
    window: Optional[int] = None
    global_every: int = 6
    # Hymba: indices of global-attention layers (first/middle/last).
    hymba_global_layers: tuple = ()

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # Modality frontend: "tokens" (LM) or "frames" (precomputed patch/frame
    # embeddings, the paper-assigned vlm/audio entries).
    frontend: str = "tokens"
    frame_dim: int = 0           # embedding dim of precomputed frames

    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"

    # RWKV6 chunked-scan length (parallel linear-attention formulation).
    rwkv_chunk: int = 128

    # The reference's dry-run cost-variant knobs, kept as data:
    # ``attention_impl="naive"`` selects the single-shot attention.
    attention_impl: str = "chunked"   # "chunked" | "naive"
    unroll_layers: bool = False
    rwkv_unroll: bool = False

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        assert self.n_heads > 0
        return self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.activation_dtype)

    @property
    def is_attention_free(self) -> bool:
        return self.attn_type == "rwkv6"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence scaling: SSM / hybrid-window archs."""
        return self.attn_type in ("rwkv6", "hymba")

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attn_type == "gqa":
            hd = self.head_dim_
            per_layer += d * hd * (self.n_heads + 2 * self.n_kv_heads) + \
                self.n_heads * hd * d
        elif self.attn_type == "mla":
            m = self.mla
            qk = m.nope_head_dim + m.rope_head_dim
            per_layer += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
            per_layer += d * (m.kv_lora_rank + m.rope_head_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        elif self.attn_type == "rwkv6":
            per_layer += 4 * d * d + d * d  # r,k,v,g,o (approx; + small loras)
        elif self.attn_type == "hymba":
            hd = self.head_dim_
            att = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            di = self.n_heads * hd
            ssm = d * 2 * di + di * d + di * (self.ssm.d_state * 2 + 8)
            per_layer += att + ssm
        if self.moe:
            e = self.moe
            per_layer += d * e.n_experts  # router
            per_layer += e.n_experts * 3 * d * e.d_ff_expert
            per_layer += e.n_shared * 3 * d * e.d_ff_shared
        else:
            per_layer += 3 * d * f
        return emb + L * per_layer

    def n_active_params(self) -> int:
        """Activated parameters per token (MoE: only routed-to experts)."""
        if not self.moe:
            return self.n_params()
        e = self.moe
        d, L = self.d_model, self.n_layers
        dense = self.n_params() - L * e.n_experts * 3 * d * e.d_ff_expert
        return dense + L * e.top_k * 3 * d * e.d_ff_expert
