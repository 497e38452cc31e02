"""The optimizer (PyTorch counterpart of ``repro.optim``): AdamW with
float32 moments, global-norm clipping, the warmup-cosine schedule (on a
mesh, ZeRO-1: each rank its block of the moments), and int8 gradient
compression with its compressed all-reduce over a mesh axis
(``compressed_psum_spec``)."""
from .adamw import (AdamWConfig, OptState, init_opt_state, adamw_update,
                    warmup_cosine, clip_by_global_norm, global_norm)
from .compress import compress_int8, compressed_psum_spec, decompress_int8

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update",
           "warmup_cosine", "clip_by_global_norm", "global_norm",
           "compress_int8", "compressed_psum_spec", "decompress_int8"]
