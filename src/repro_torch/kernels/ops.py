"""Kernel entry points, dispatched by the tensors' device (the port's
counterpart of ``repro.kernels.ops``): a CPU tensor takes the kernel's
plain PyTorch version, a CUDA tensor launches the hand-written kernel or
the call raises. There is no environment switch and no fallback.

``flash_attention`` is differentiable: its forward is the kernel, and its
backward re-runs the plain ``ref.attention`` under autograd, as the JAX
package's ``custom_vjp`` recomputes through its reference.
"""
from __future__ import annotations

import torch

from . import ref
from .decode_attention import decode_attention_cuda
from .flash_attention import flash_attention_cuda
from .hmmu_lookup import hmmu_lookup, hmmu_lookup_fused
from .rwkv_scan import rwkv_chunk_scan_cuda, rwkv_scan_plain

__all__ = ["hmmu_lookup", "hmmu_lookup_fused", "flash_attention",
           "decode_attention", "rwkv_chunk"]


def _on_cuda(*tensors: torch.Tensor) -> bool:
    return any(t.is_cuda for t in tensors)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, scale)
        fwd = flash_attention_cuda if _on_cuda(q, k, v) else ref.attention
        return fwd(q, k, v, causal=causal, window=window, scale=scale)

    @staticmethod
    def backward(ctx, g):
        # The plain version recomputed in float32 under autograd, each
        # gradient rounded once to its input's dtype (a GQA group's dk and
        # dv summed in float32, not head by head in bfloat16).
        causal, window, scale = ctx.mask
        saved = ctx.saved_tensors
        inputs = [x.detach().float().requires_grad_() for x in saved]
        with torch.enable_grad():
            out = ref.attention(*inputs, causal=causal, window=window,
                                scale=scale)
        grads = torch.autograd.grad(out, inputs, g.float())
        return (*(d.to(x.dtype) for d, x in zip(grads, saved)),
                None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """[B, Hq, Sq, D] x [B, Hkv, Skv, D]^2 -> [B, Hq, Sq, D]."""
    return _FlashAttention.apply(q, k, v, causal, window, scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     scale: float | None = None,
                     window: int | None = None) -> torch.Tensor:
    """[B, Hq, D] x [B, Hkv, Smax, D]^2 x int32[B] -> [B, Hq, D]. At
    ``kv_len == 0`` the kernel gives 0, the plain version the mean of V."""
    fn = decode_attention_cuda if _on_cuda(q, k_cache, v_cache, kv_len) \
        else ref.decode_attention
    return fn(q, k_cache, v_cache, kv_len, scale=scale, window=window)


def rwkv_chunk(r, k, v, logw, u, *, chunk: int = 128) -> torch.Tensor:
    """[B,H,S,D]^4 + [H,D] -> fp32 [B,H,S,Dv]; the final state is not
    returned (``models.rwkv.rwkv_chunk_scan`` gives it)."""
    if _on_cuda(r, k, v, logw, u):
        return rwkv_chunk_scan_cuda(r, k, v, logw, u, chunk)
    return rwkv_scan_plain(r, k, v, logw, u, chunk)[0]
