"""phi3.5-moe-42b-a6.6b [moe]: 16 experts, top-2 routing.
32L d4096 32H (GQA kv=8) d_ff 6400 vocab 32064.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.models import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=6400, vocab=32064, head_dim=128, attn_type="gqa",
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400))


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=128,
        head_dim=16, moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96),
        param_dtype="float32", activation_dtype="float32")
