"""musicgen-medium [audio]: decoder-only over EnCodec tokens.
48L d1536 24H (kv=24) d_ff 6144 vocab 2048. [arXiv:2306.05284; hf]

Modality frontend (EnCodec codebook-sum embeddings) is a STUB:
input_specs() supplies precomputed frame embeddings; generation emits
EnCodec token ids (vocab 2048).
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", n_layers=48, d_model=1536, n_heads=24,
        n_kv_heads=24, d_ff=6144, vocab=2048, head_dim=64,
        attn_type="gqa", frontend="frames", frame_dim=512)


def smoke_config() -> ModelConfig:
    return config().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab=64, head_dim=16, frame_dim=24,
                          param_dtype="float32", activation_dtype="float32")
