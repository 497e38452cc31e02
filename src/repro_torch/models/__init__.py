"""The model zoo of the port (PyTorch counterpart of ``repro.models``):
every family of the reference over plain PyTorch layers. ``transformer``
assembles init, prefill and decode for dense GQA, MLA (``mla``), RWKV6
(``rwkv``, whose chunked scan is also the plain version of the RWKV
kernel) and Hymba's attention + Mamba (``mamba``), with SwiGLU, RWKV
channel-mix or mixture-of-experts (``moe``) FFNs, and ``loss_fn``, the
training objective, whose backward is autograd's over the same layers
(``chunked_attention`` has the reference's blocked backward). On a
``torch.distributed`` mesh (``ShardCtx.from_mesh``) the same entry points
run SPMD: context-parallel attention, the expert-parallel MoE and the
decode combine over a sequence-split cache (``sharding``); for training,
the parameters held as the reference's specs say and gathered where
each layer uses them (``ShardCtx.with_stored``)."""
from .config import ModelConfig, MoEConfig, MLAConfig, SSMConfig
from .sharding import ShardCtx
from .transformer import (init_params, forward_seq, loss_fn, prefill,
                          decode_step, init_cache, layer_windows,
                          hymba_cache_sizes, reduce_grads, shard_params)

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "ShardCtx",
           "init_params", "forward_seq", "loss_fn", "prefill", "decode_step",
           "init_cache", "layer_windows", "hymba_cache_sizes",
           "reduce_grads", "shard_params"]
