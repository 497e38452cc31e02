"""hymba-1.5b [hybrid]: parallel attention + mamba heads per layer.
32L d1600 25H (kv=5, head_dim 64) d_ff 5504 vocab 32001, ssm_state=16.
Sliding-window (1024) attention except global layers {0, 16, 31}.
[arXiv:2411.13676; hf]
Runs long_500k (windowed attention + O(1) SSM state).
"""
from repro_torch.models import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", n_layers=32, d_model=1600, n_heads=25,
        n_kv_heads=5, d_ff=5504, vocab=32001, head_dim=64,
        attn_type="hymba", window=1024, hymba_global_layers=(0, 16, 31),
        ssm=SSMConfig(d_state=16, d_conv=4))


def smoke_config() -> ModelConfig:
    return config().with_(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=128, head_dim=16, window=8,
                          hymba_global_layers=(0, 2),
                          ssm=SSMConfig(d_state=4, d_conv=3),
                          param_dtype="float32", activation_dtype="float32")
