"""HMMU redirection-table lookup: a hand-written CUDA gather for Hopper.

Replaces the TPU kernel ``repro/kernels/hmmu_lookup.py::hmmu_lookup``
(its ``pallas_call`` at line 78; ``hmmu_lookup_fused`` at line 87 goes
through it). For every request of a chunk it fetches the page's packed
32-byte table row (``core.table`` layout), with page indices clamped to
``[0, n_pages)``; the fused form appends the DMA swap pair, so stage 2 of
the chunk step is one launch of ``m + 2`` rows.

``hmmu_lookup`` dispatches on the tensors' device: a CPU tensor takes the
plain version (:func:`hmmu_lookup_plain`), a CUDA tensor launches the
kernel ``csrc/hmmu_lookup.cu`` or raises. There is no other path.
"""
from __future__ import annotations

import torch

from .build import INT, PTR, CudaKernel, check_cuda
from .ref import fused_gather, hmmu_lookup as hmmu_lookup_plain

ROW_W = 8

KERNEL = CudaKernel("hmmu_lookup", "hmmu_lookup_launch",
                    (PTR, PTR, PTR, INT, INT, INT))


def hmmu_lookup_cuda(table: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA gather. table: int32[*batch, n_pages, 8] and pages:
    int32[*batch, m], both contiguous on one CUDA device."""
    dev = check_cuda("hmmu_lookup_cuda", table, pages)
    if table.dtype != torch.int32 or pages.dtype != torch.int32:
        raise TypeError("hmmu_lookup_cuda takes int32 table and pages")
    if table.dim() < 2 or table.shape[-1] != ROW_W:
        raise ValueError(f"table must be [*batch, n_pages, {ROW_W}], got "
                         f"{tuple(table.shape)}")
    if pages.shape[:-1] != table.shape[:-2]:
        raise ValueError(f"batch dims disagree: table {tuple(table.shape)} "
                         f"vs pages {tuple(pages.shape)}")
    n_pages, m = table.shape[-2], pages.shape[-1]
    batch = pages.numel() // max(m, 1)
    out = torch.empty(*pages.shape, ROW_W, dtype=torch.int32, device=dev)
    if out.numel():
        KERNEL.launch(dev, table.data_ptr(), pages.data_ptr(),
                      out.data_ptr(), batch, n_pages, m)
    return out


def hmmu_lookup(table: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """int32[*batch, n_pages, 8] x int32[*batch, m] -> int32[*batch, m, 8]:
    the plain gather for CPU tensors, the CUDA kernel for CUDA tensors."""
    if table.is_cuda or pages.is_cuda:
        return hmmu_lookup_cuda(table, pages)
    return hmmu_lookup_plain(table, pages)


def hmmu_lookup_fused(table: torch.Tensor, pages: torch.Tensor,
                      extra: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather a chunk's rows and ``k`` extra rows (the DMA swap pair) in
    ONE lookup: returns (int32[*batch, m, 8], int32[*batch, k, 8])."""
    return fused_gather(hmmu_lookup, table, pages, extra)
