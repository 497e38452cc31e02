"""Blocked GQA flash attention: a hand-written CUDA kernel for Hopper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (its ``pallas_call`` at line 111). Causal and
sliding-window masks, a query that is the tail of the kv sequence, fp32
online softmax, output in ``q.dtype``; see ``csrc/flash_attention.cu``.
Its entry point takes one of two paths by dtype and head dim and reports
which: ``"wgmma"`` (bf16 at D % 8 == 0, built for D 64, 128 or 256 with
the columns past D read as zeros: TMA, wgmma, warp specialisation) or
``"mma"`` (fp32 at any D, bf16 at D % 8 != 0: ``mma.sync`` on the TF32
tensor cores, every product 3xTF32); ``KERNEL.variant_launches`` counts
each.
The plain version is :func:`flash_attention_plain` (``ref.attention``);
``ops.flash_attention`` chooses between the two by the tensors' device.
"""
from __future__ import annotations

import torch

from .build import FLOAT, INT, PTR, CudaKernel, check_cuda, dtype_code
from .ref import attention as flash_attention_plain

__all__ = ["KERNEL", "flash_attention_cuda", "flash_attention_plain"]

KERNEL = CudaKernel("flash_attention", "flash_attention_launch",
                    (PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT,
                     INT, INT, INT, FLOAT), variants=("mma", "wgmma"))

BLOCK = 128        # the TPU kernel's default q and kv block
MAX_HEAD_DIM = 256

# The head dims each path is built for (csrc/flash_attention.cu: the
# "mma" path's FA_CASE list, the "wgmma" path's D 64, 128 and 256).
MMA_DIMS = (16, 32, 64, 96, 128, 192, 256)
WGMMA_DIMS = (64, 128, 256)


def path_of(d: int, dtype: torch.dtype) -> str:
    """The path a call takes: "wgmma" for bf16 at D % 8 == 0, else
    "mma"."""
    return "wgmma" if dtype == torch.bfloat16 and d % 8 == 0 else "mma"


def smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block (``Tile<DP>::kBytes`` and
    ``wg::Tile<D>::kBytes`` in ``csrc/flash_attention.cu``): "mma" holds Q
    [128, DP + 4] and two stages of K and V [BK, DP + 4] in float32 (BK 64,
    32 at DP 96 and 192, 16 at 256); "wgmma" Q [128, D] and two stages of
    K and V [BK, D] in bf16 (BK 128, 64 at D 256), 56 bytes of barriers
    and 1,024 of alignment."""
    if path_of(d, dtype) == "wgmma":
        dp = next(x for x in WGMMA_DIMS if d <= x)
        bk = 64 if dp == 256 else 128
        return 128 * dp * 2 + 4 * bk * dp * 2 + 8 * 7 + 1024
    dp = next(x for x in MMA_DIMS if d <= x)
    bk = 32 if dp in (96, 192) else 16 if dp == 256 else 64
    return (128 + 4 * bk) * (dp + 4) * 4


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel. q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D],
    contiguous on one CUDA device, all fp32 or all bf16. Takes the shapes
    the TPU kernel takes at its default blocks: Sq and Skv multiples of
    ``min(128, length)``."""
    dev = check_cuda("flash_attention_cuda", q, k, v)
    code = dtype_code("flash_attention_cuda", q, k, v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention_cuda takes q [B,Hq,Sq,D] and "
                         f"k, v [B,Hkv,Skv,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree (batch, head dim, or Hq % Hkv)")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside (0, {MAX_HEAD_DIM}]")
    for name, n in (("Sq", sq), ("Skv", skv)):
        if n == 0 or n % min(BLOCK, n):
            raise ValueError(f"{name} = {n} is not a multiple of "
                             f"min({BLOCK}, {name})")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    KERNEL.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), code, b, hq, hkv, sq, skv, d, int(causal),
                  int(window is not None), int(window or 0), float(scale))
    return out
