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

__all__ = ["KERNEL", "LAUNCHES", "rwkv_chunk_scan_cuda", "rwkv_scan_plain",
           "smem_bytes"]

KERNEL = CudaKernel("rwkv_scan", "rwkv_scan_launch",
                    (PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT,
                     INT, INT, INT, INT))

# The device kernels that one launch enqueues, in order (their names in a
# profiler trace).
LAUNCHES = ("chunk_state_kernel", "state_scan_kernel", "chunk_out_kernel")

MAX_CHUNK = 256    # the kernel's prefix sum takes one level of 16-blocks


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(c: int, dk: int, dv: int) -> int:
    """Shared memory of one output block at chunk ``c`` (``out_smem_floats``
    in ``csrc/rwkv_scan.cu``, the larger of the two chunk launches): qp
    and kp [C, Dk + 4]; logw, then the state [Dk, Dv + 8], then v
    [C, Dv + 4] in one buffer; diag [C], u [Dk] and the prefix sum's block
    totals [C / 16, Dk]; C and Dk padded to 16, Dv to 64. At rwkv6 width
    (64) chunk 256 fits the H100's 227 KB; at width 128 a chunk past 128
    tokens does not."""
    cp, dkp, dvp = _up(c, 16), _up(dk, 16), _up(dv, 64)
    return 4 * (2 * cp * (dkp + 4) + max(cp * (max(dkp, dvp) + 4),
                                         dkp * (dvp + 8))
                + cp + dkp + cp // 16 * dk)


def rwkv_chunk_scan_cuda(r, k, v, logw, u, chunk: int = 128) -> torch.Tensor:
    """Launch the CUDA kernel. r/k/logw [B,H,S,Dk], v [B,H,S,Dv] (all fp32
    or all bf16), u [H,Dk] (cast to fp32), contiguous on one CUDA device
    -> fp32 [B,H,S,Dv]. S must be a multiple of ``min(chunk, S)``, as in
    the TPU kernel, and the chunk must fit one block's shared memory. One
    counted launch enqueues the kernel's three device kernels; the
    scratch they share (fp32 [B*H, S/C, Dk, Dv] and [B*H, S/C, Dk]) is
    allocated here."""
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
    # Each chunk's state term U_n, then the state S_n entering it, in place;
    # and each chunk's total log-decay.
    states = torch.empty((b * h, s // c, dk, dv), dtype=torch.float32,
                         device=dev)
    decay = torch.empty((b * h, s // c, dk), dtype=torch.float32, device=dev)
    KERNEL.launch(dev, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                  logw.data_ptr(), u.data_ptr(), out.data_ptr(),
                  states.data_ptr(), decay.data_ptr(), code, b, h, s, dk, dv,
                  c)
    return out
