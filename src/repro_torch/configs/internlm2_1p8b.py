"""internlm2-1.8b [dense]: GQA. 24L d2048 16H (kv=8) d_ff 8192
vocab 92544. [arXiv:2403.17297; hf]
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=8, d_ff=8192, vocab=92544, head_dim=128, attn_type="gqa")


def smoke_config() -> ModelConfig:
    return config().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=128, head_dim=16,
                          param_dtype="float32", activation_dtype="float32")
