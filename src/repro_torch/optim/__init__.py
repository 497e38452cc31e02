"""The optimizer (PyTorch counterpart of ``repro.optim``): AdamW with
float32 moments, global-norm clipping, the warmup-cosine schedule, and
int8 gradient compression. The compressed cross-pod all-reduce
(``compressed_psum_spec``) belongs to training over a mesh, the next
item of ROADMAP §1."""
from .adamw import (AdamWConfig, OptState, init_opt_state, adamw_update,
                    warmup_cosine, clip_by_global_norm, global_norm)
from .compress import compress_int8, decompress_int8

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update",
           "warmup_cosine", "clip_by_global_norm", "global_norm",
           "compress_int8", "decompress_int8"]
