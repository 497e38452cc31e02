"""The model zoo of the port (PyTorch counterpart of ``repro.models``):
the dense GQA family (``transformer``: init, prefill, decode) over plain
PyTorch layers, and RWKV6's chunked scan (``rwkv.rwkv_chunk_scan``, the
plain version of the RWKV kernel). The other block families and MoE wait
for later slices (ROADMAP §1 items 3.2 and 3.3)."""
from .config import ModelConfig, MoEConfig, MLAConfig, SSMConfig
from .sharding import ShardCtx
from .transformer import (init_params, forward_seq, prefill, decode_step,
                          init_cache, layer_windows)

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "ShardCtx",
           "init_params", "forward_seq", "prefill", "decode_step",
           "init_cache", "layer_windows"]
