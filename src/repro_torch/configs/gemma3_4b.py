"""gemma3-4b [dense]: 5:1 local(1024-window):global interleave, 128k
context, tied embeddings. 34L d2560 8H (kv=4, head_dim 256) d_ff 10240
vocab 262144. [hf:google/gemma-3-1b-pt; unverified]

8 q heads cannot split a 16-way model axis: attention runs batch-parallel
with replicated attention weights; FFN/vocab are model-sharded
(models.sharding head rules).
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", n_layers=34, d_model=2560, n_heads=8,
        n_kv_heads=4, d_ff=10240, vocab=262144, head_dim=256,
        attn_type="gqa", window=1024, global_every=6, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return config().with_(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=256, head_dim=16, window=8,
                          global_every=3,
                          param_dtype="float32", activation_dtype="float32")
