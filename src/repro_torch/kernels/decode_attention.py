"""Flash decode, one-token GQA attention over a padded KV cache: a
hand-written CUDA kernel for Hopper.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::
decode_attention`` (its ``pallas_call`` at line 100). Per-sequence
``kv_len``, an optional sliding window, cache tiles past ``kv_len``
skipped; see ``csrc/decode_attention.cu``. The plain version is
:func:`decode_attention_plain` (``ref.decode_attention``);
``ops.decode_attention`` chooses between the two by the tensors' device.
The two differ where ``kv_len == 0``: the kernel returns 0 there (as the
TPU kernel does), the plain version the mean of V (as the JAX reference
does).
"""
from __future__ import annotations

import torch

from .build import FLOAT, INT, PTR, CudaKernel, check_cuda, dtype_code
from .ref import decode_attention as decode_attention_plain

__all__ = ["KERNEL", "decode_attention_cuda", "decode_attention_plain"]

KERNEL = CudaKernel("decode_attention", "decode_attention_launch",
                    (PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT,
                     INT, INT, FLOAT))

BLOCK_K = 512      # the TPU kernel's default cache block
MAX_HEAD_DIM = 256


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                          scale: float | None = None,
                          window: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel. q: [B, Hq, D]; caches [B, Hkv, Smax, D]
    (all fp32 or all bf16); kv_len int32[B]; contiguous on one CUDA
    device. Smax must be a multiple of ``min(512, Smax)``, as the TPU
    kernel's default block requires."""
    dev = check_cuda("decode_attention_cuda", q, k_cache, v_cache, kv_len)
    code = dtype_code("decode_attention_cuda", q, k_cache, v_cache)
    if kv_len.dtype != torch.int32:
        raise TypeError("decode_attention_cuda takes int32 kv_len")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention_cuda takes q [B,Hq,D] and caches "
                         f"[B,Hkv,Smax,D], got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, hq, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d or hkv == 0 or \
            hq % hkv or kv_len.shape != (b,):
        raise ValueError(f"q {tuple(q.shape)}, cache {tuple(k_cache.shape)} "
                         f"and kv_len {tuple(kv_len.shape)} disagree")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside (0, {MAX_HEAD_DIM}]")
    if smax == 0 or smax % min(BLOCK_K, smax):
        raise ValueError(f"Smax = {smax} is not a multiple of "
                         f"min({BLOCK_K}, Smax)")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    KERNEL.launch(dev, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  kv_len.data_ptr(), out.data_ptr(), code, b, hq, hkv, smax,
                  d, int(window is not None), int(window or 0), float(scale))
    return out
