"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP patch frontend (stub).
32L d3072 32H (kv=32) d_ff 8192 vocab 32064.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (CLIP-L/14 hidden size 1024); the learned
adapter projection + the full LM backbone are real.
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", n_layers=32, d_model=3072, n_heads=32,
        n_kv_heads=32, d_ff=8192, vocab=32064, head_dim=96,
        attn_type="gqa", frontend="frames", frame_dim=1024)


def smoke_config() -> ModelConfig:
    return config().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab=128, head_dim=16, frame_dim=24,
                          param_dtype="float32", activation_dtype="float32")
