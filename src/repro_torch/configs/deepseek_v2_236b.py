"""deepseek-v2-236b [moe]: MLA (kv_lora=512) + 2 shared / 160 routed
top-6 experts. 60L d5120 128H d_ff(expert) 1536 vocab 102400.
[arXiv:2405.04434; hf]

Deviation noted per DESIGN.md: the reference model keeps layer 0 dense;
here all 60 layers are MoE (uniform layer stack for the scanned body).
Shared experts are fused into one SwiGLU of width 2*1536.
"""
from repro_torch.models import ModelConfig, MoEConfig, MLAConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
        n_kv_heads=128, d_ff=12288, vocab=102400, attn_type="mla",
        head_dim=128,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                      n_shared=2, d_ff_shared=3072))


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
        head_dim=16,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=2,
                      d_ff_shared=64),
        param_dtype="float32", activation_dtype="float32")
