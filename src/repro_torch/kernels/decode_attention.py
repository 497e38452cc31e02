"""Flash decode, one-token GQA attention over a padded KV cache: a
hand-written CUDA kernel for Hopper, split over the cache.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::
decode_attention`` (its ``pallas_call`` at line 100). Per-sequence
``kv_len`` and an optional sliding window. The cache axis is cut into
``n_split`` splits of ``L`` rows (:func:`split_plan`), each read by its own
thread blocks into an fp32 partial ``(m, l, acc)``; a second kernel merges
the partials (:func:`combine_partials` is that merge in PyTorch). See
``csrc/decode_attention.cu``. The plain version is
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

__all__ = ["KERNEL", "decode_attention_cuda", "decode_attention_plain",
           "split_plan", "split_ranges", "combine_partials"]

KERNEL = CudaKernel("decode_attention", "decode_attention_launch",
                    (PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                     INT, INT, INT, INT, INT, INT, FLOAT))

BLOCK_K = 512      # the TPU kernel's default cache block
MAX_ROW_BYTES = 1024   # 64 lanes' worth of 16-byte loads
MIN_SPLIT = 64         # fewest cache rows a split reads
MAX_BLOCKS = 2048      # ~16 split blocks per SM of the H100's 132


def smem_bytes(hq: int, hkv: int) -> int:
    """Shared memory of one split block (``csrc/decode_attention.cu``): the
    ring of 4 stages of K and V chunks of 8,192 bytes (dynamic), and the
    warps' running max and sum [4][GT] in float32 with the stages' 8-byte
    barriers (static); GT, the query heads a block serves, is the group
    size rounded up to 1, 2, 4 or 8."""
    group = hq // hkv
    gt = next((g for g in (1, 2, 4) if group <= g), 8)
    return 4 * 2 * 8192 + 2 * 4 * gt * 4 + 8 * 4


def split_plan(b: int, hkv: int, smax: int,
               window: int | None = None) -> tuple[int, int]:
    """(n_split, L): the cache axis of every sequence is read as n_split
    splits of L rows from the first valid row. Chosen from Smax, or from
    the window, never from ``kv_len`` (reading it would synchronise): L
    is the smallest power of two >= 64 that keeps B * Hkv * n_split at
    most 2,048 blocks, and n_split * L covers the longest valid range."""
    span = min(smax, window) if window is not None else smax
    span = max(span, 1)
    length = MIN_SPLIT
    while length < span and b * hkv * -(-span // length) > MAX_BLOCKS:
        length *= 2
    return -(-span // length), length


def split_ranges(kv_len: int, smax: int, n_split: int, length: int,
                 window: int | None = None) -> list[tuple[int, int]]:
    """The rows [r0, r1) that each split reads for one sequence (empty
    splits as r0 >= r1), as the kernel computes them."""
    hi = min(kv_len, smax)
    lo = max(0, kv_len - window) if window is not None else 0
    return [(lo + s * length, min(lo + (s + 1) * length, hi))
            for s in range(n_split)]


def combine_partials(m: torch.Tensor, l: torch.Tensor,
                     acc: torch.Tensor) -> torch.Tensor:
    """Merge the splits' fp32 partials, as the combine kernel does.
    m, l: [..., n_split]; acc: [..., n_split, D] -> fp32 [..., D]. An
    empty split holds (m, l, acc) = (-1e30, 0, 0); when every split is
    empty the result is 0."""
    big = m.max(dim=-1, keepdim=True).values
    w = torch.exp(m - big)
    den = (w * l).sum(dim=-1, keepdim=True)
    num = (w[..., None] * acc).sum(dim=-2)
    return num / torch.where(den == 0, torch.ones_like(den), den)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                          scale: float | None = None,
                          window: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernels (split, then combine). q: [B, Hq, D];
    caches [B, Hkv, Smax, D] (all fp32 or all bf16); kv_len int32[B];
    contiguous on one CUDA device. Smax must be a multiple of
    ``min(512, Smax)``, as the TPU kernel's default block requires, and a
    row of D elements whole 16-byte vectors, at most 1,024 bytes."""
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
    row = d * q.element_size()
    if d == 0 or row % 16 or row > MAX_ROW_BYTES:
        raise ValueError(f"head dim {d} of {q.dtype}: a row of {row} bytes "
                         f"is not whole 16-byte vectors up to "
                         f"{MAX_ROW_BYTES} bytes")
    if smax == 0 or smax % min(BLOCK_K, smax):
        raise ValueError(f"Smax = {smax} is not a multiple of "
                         f"min({BLOCK_K}, Smax)")
    if window is not None and window < 0:
        raise ValueError(f"window {window} is negative")
    scale = scale if scale is not None else d ** -0.5
    n_split, length = split_plan(b, hkv, smax, window)
    part_ml = torch.empty((b, hq, n_split, 2), dtype=torch.float32,
                          device=dev)
    part_acc = torch.empty((b, hq, n_split, d), dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    KERNEL.launch(dev, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  kv_len.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
                  part_acc.data_ptr(), code, b, hq, hkv, smax, d, length,
                  n_split, int(window is not None), int(window or 0),
                  float(scale))
    return out
