"""HMMU redirection-table lookup (kernel A): a hand-written CUDA gather
for Hopper.

Replaces the TPU kernel ``repro/kernels/hmmu_lookup.py::hmmu_lookup``
(its ``pallas_call`` at line 78; ``hmmu_lookup_fused`` at line 87 goes
through it). For every request of a chunk it fetches the page's packed
32-byte table row (``core.table`` layout), with page indices clamped to
``[0, n_pages)``.

:func:`hmmu_lookup_fused` is stage 2 of the scan-path chunk step: for B
design points at once (the sweep's point axis) it gathers every point's
chunk rows and its DMA swap pair from the point's own table in ONE launch
of ``csrc/hmmu_lookup.cu``, taking the raw DMA registers (-1 when idle)
and clamping them itself, so nothing else is launched around it. A chunk
that every point shares may come as an expanded view (point stride 0):
it is read where it lies, never copied a point. :func:`hmmu_lookup` is
the unfused gather, for ``fuse_swap_gather=False``.

Both dispatch on the tensors' device: CPU tensors take the plain version
(``kernels/ref.py``), CUDA tensors launch the kernel or raise. There is
no other path. Every launch of either entry adds one to
``KERNEL.launches``.
"""
from __future__ import annotations

import torch

from . import ref
from .build import INT, LONG, PTR, CudaKernel, check_cuda

ROW_W = 8

KERNEL = CudaKernel("hmmu_lookup", "hmmu_lookup_launch",
                    (PTR, PTR, PTR, INT, INT, INT),
                    entries={"hmmu_lookup_fused_launch":
                             (PTR,) * 6 + (INT,) * 3 + (LONG,) * 3})

hmmu_lookup_plain = ref.hmmu_lookup
hmmu_lookup_fused_plain = ref.hmmu_lookup_fused


def _check_table(name: str, table: torch.Tensor) -> None:
    if table.dtype != torch.int32:
        raise TypeError(f"{name} takes an int32 table")
    if table.dim() < 2 or table.shape[-1] != ROW_W:
        raise ValueError(f"table must be [*batch, n_pages, {ROW_W}], got "
                         f"{tuple(table.shape)}")


def hmmu_lookup_cuda(table: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA gather. table: int32[*batch, n_pages, 8] and pages:
    int32[*batch, m], both contiguous on one CUDA device."""
    dev = check_cuda("hmmu_lookup_cuda", table, pages)
    _check_table("hmmu_lookup_cuda", table)
    if pages.dtype != torch.int32:
        raise TypeError("hmmu_lookup_cuda takes int32 pages")
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


def hmmu_lookup_fused_cuda(table: torch.Tensor, pages: torch.Tensor,
                           page_a: torch.Tensor, page_b: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused gather once for every point. table: int32[B,
    n_pages, 8] contiguous; pages: int32[B, m] whose rows are contiguous
    (any point stride, 0 for a shared chunk); page_a, page_b: int32[B],
    any stride. All on one CUDA device. Without a point axis (table
    [n_pages, 8], pages [m], 0-dim registers) it is one point."""
    if table.dim() == 2:
        rows, swap = hmmu_lookup_fused_cuda(table[None], pages[None],
                                            page_a[None], page_b[None])
        return rows[0], swap[0]
    dev = check_cuda("hmmu_lookup_fused_cuda", table)
    _check_table("hmmu_lookup_fused_cuda", table)
    for name, t, shape in (("pages", pages, (table.shape[0], -1)),
                           ("page_a", page_a, (table.shape[0],)),
                           ("page_b", page_b, (table.shape[0],))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, table on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != len(shape) or t.shape[0] != shape[0]:
            raise ValueError(f"{name} must be {shape} (B = points), got "
                             f"{tuple(t.shape)}")
    b, n_pages, _ = table.shape
    m = pages.shape[1]
    if m > 1 and pages.stride(1) != 1:
        raise ValueError("each point's chunk of pages must be contiguous")
    rows = torch.empty(b, m, ROW_W, dtype=torch.int32, device=dev)
    swap = torch.empty(b, 2, ROW_W, dtype=torch.int32, device=dev)
    if b:
        KERNEL.launch(dev, table.data_ptr(), pages.data_ptr(),
                      page_a.data_ptr(), page_b.data_ptr(), rows.data_ptr(),
                      swap.data_ptr(), b, n_pages, m, pages.stride(0),
                      page_a.stride(0), page_b.stride(0),
                      symbol="hmmu_lookup_fused_launch")
    return rows, swap


def _on_cuda(*tensors: torch.Tensor) -> bool:
    return any(t.is_cuda for t in tensors)


def hmmu_lookup(table: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """int32[*batch, n_pages, 8] x int32[*batch, m] -> int32[*batch, m, 8]:
    the plain gather for CPU tensors, the CUDA kernel for CUDA tensors."""
    if _on_cuda(table, pages):
        return hmmu_lookup_cuda(table, pages)
    return hmmu_lookup_plain(table, pages)


def hmmu_lookup_fused(table: torch.Tensor, pages: torch.Tensor,
                      page_a: torch.Tensor, page_b: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """A chunk's rows and the DMA swap pair's rows in ONE lookup, for every
    point: table [B, n_pages, 8], pages [B, m], the raw registers page_a
    and page_b [B] -> (int32[B, m, 8], int32[B, 2, 8]); or one point
    without the B axis."""
    if _on_cuda(table, pages, page_a, page_b):
        return hmmu_lookup_fused_cuda(table, pages, page_a, page_b)
    return hmmu_lookup_fused_plain(table, pages, page_a, page_b)
