"""phi3-mini-3.8b [dense]: RoPE SwiGLU GQA. 32L d3072 32H (kv=32)
d_ff 8192 vocab 32064. [arXiv:2404.14219; unverified]
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", n_layers=32, d_model=3072, n_heads=32,
        n_kv_heads=32, d_ff=8192, vocab=32064, head_dim=96, attn_type="gqa")


def smoke_config() -> ModelConfig:
    return config().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab=128, head_dim=16,
                          param_dtype="float32", activation_dtype="float32")
