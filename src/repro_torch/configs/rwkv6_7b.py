"""rwkv6-7b [ssm] "Finch": attention-free, data-dependent decay.
32L d4096 d_ff 14336 vocab 65536. [arXiv:2404.05892; hf]
64 heads of 64 channels; chunked-parallel linear attention (models.rwkv).
Runs long_500k (O(1) state decode).
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", n_layers=32, d_model=4096, n_heads=64,
        n_kv_heads=64, d_ff=14336, vocab=65536, head_dim=64,
        attn_type="rwkv6")


def smoke_config() -> ModelConfig:
    return config().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab=128, head_dim=16, rwkv_chunk=8,
                          param_dtype="float32", activation_dtype="float32")
