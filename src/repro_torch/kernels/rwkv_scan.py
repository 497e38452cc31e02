"""RWKV6 chunked linear attention: a hand-written CUDA kernel for Hopper.

Replaces the TPU kernel ``repro/kernels/rwkv_scan.py::rwkv_chunk_scan``
(its ``pallas_call`` at line 84): the strictly-lower intra-chunk term,
the ``u`` bonus on the diagonal, and the ``[Dk, Dv]`` state carried across
chunks; fp32 output, no final state. See ``csrc/rwkv_scan.cu``. The plain
version is :func:`rwkv_scan_plain` (``models.rwkv.rwkv_chunk_scan``, whose
output is the kernel's); ``ops.rwkv_chunk`` chooses between the two by
the tensors' device.
"""
from __future__ import annotations

import torch

from ..models.rwkv import rwkv_chunk_scan as rwkv_scan_plain
from .build import INT, PTR, CudaKernel, check_cuda, dtype_code

__all__ = ["KERNEL", "rwkv_chunk_scan_cuda", "rwkv_scan_plain", "smem_bytes"]

KERNEL = CudaKernel("rwkv_scan", "rwkv_scan_launch",
                    (PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT,
                     INT, INT))

MAX_CHUNK = 256    # the kernel's prefix sum takes one level of 16-blocks


def smem_bytes(c: int, dk: int, dv: int) -> int:
    """Shared memory of one block at chunk ``c`` (``smem_floats`` in
    ``csrc/rwkv_scan.cu``): a chunk of rwkv6 width (64) fits the H100's
    227 KB up to ~135 tokens."""
    ldk, ldv = dk + 1, dv + 1
    return 4 * (3 * c * ldk + c * ldv + c * max(c + 1, ldk) + dk * ldv
                + c + 2 * dk)


def rwkv_chunk_scan_cuda(r, k, v, logw, u, chunk: int = 128) -> torch.Tensor:
    """Launch the CUDA kernel. r/k/logw [B,H,S,Dk], v [B,H,S,Dv] (all fp32
    or all bf16), u [H,Dk] (cast to fp32), contiguous on one CUDA device
    -> fp32 [B,H,S,Dv]. S must be a multiple of ``min(chunk, S)``, as in
    the TPU kernel, and the chunk must fit one block's shared memory."""
    dev = check_cuda("rwkv_chunk_scan_cuda", r, k, v, logw, u)
    code = dtype_code("rwkv_chunk_scan_cuda", r, k, v, logw)
    if r.dim() != 4 or k.shape != r.shape or logw.shape != r.shape or \
            v.shape[:3] != r.shape[:3] or v.dim() != 4:
        raise ValueError(f"rwkv_chunk_scan_cuda takes r/k/logw [B,H,S,Dk] "
                         f"and v [B,H,S,Dv], got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(logw.shape)}")
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    if u.shape != (h, dk):
        raise ValueError(f"u must be [H, Dk] = {(h, dk)}, got "
                         f"{tuple(u.shape)}")
    c = min(chunk, s)
    if s == 0 or s % c:
        raise ValueError(f"S = {s} is not a multiple of min(chunk={chunk}, S)")
    if c > MAX_CHUNK:
        raise ValueError(f"chunk {c} > {MAX_CHUNK}, the kernel's prefix-sum "
                         "limit")
    need = smem_bytes(c, dk, dv)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if need > limit:
        raise ValueError(f"chunk {c} at Dk={dk}, Dv={dv} needs {need} bytes "
                         f"of shared memory, more than the {limit} one "
                         "block may hold on this card")
    u = u.to(torch.float32)
    out = torch.empty((b, h, s, dv), dtype=torch.float32, device=dev)
    KERNEL.launch(dev, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                  logw.data_ptr(), u.data_ptr(), out.data_ptr(), code, b, h,
                  s, dk, dv, c)
    return out
