"""minitron-8b [dense]: pruned nemotron. 32L d4096 32H (kv=8) d_ff 16384
vocab 256000. [arXiv:2407.14679; hf]
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=16384, vocab=256000, head_dim=128,
        attn_type="gqa")


def smoke_config() -> ModelConfig:
    return config().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=128, head_dim=16,
                          param_dtype="float32", activation_dtype="float32")
