"""Latency model: stall-cycle injection (paper §III-F), PyTorch port of
``repro.core.latency``.

Every request gets ``service = device latency + transfer + bank-queue
wait + link``. Queue contention inside a chunk is resolved exactly by the
max-plus recurrence ``done_i = max(arrival_i, done_{prev}) + service_i``
in closed form: ``done_i = cummax_j(arr_j - CS_{j-1}) + CS_i`` with
``CS = cumsum(service)``, all in int32. Every scan runs along the last
axis, so a leading design-point axis resolves each point's queues alone.
"""
from __future__ import annotations

import torch

from .config import EmulatorConfig, RuntimeParams, SLOW
from .indexing import gather_index

_NEG = -(2 ** 30)  # invalid-slot arrival time


def maxplus_scan(arrival: torch.Tensor, service: torch.Tensor) -> torch.Tensor:
    """Resolve ``done_i = max(arrival_i, done_{i-1}) + service_i`` over the
    last axis in closed form (int32)."""
    cs = torch.cumsum(service, dim=-1, dtype=torch.int32)
    return torch.cummax(arrival - (cs - service), dim=-1).values + cs


def resolve_bank_queues(arrival: torch.Tensor, service: torch.Tensor,
                        bank: torch.Tensor, n_banks: int,
                        bank_free: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bank queue resolution for one chunk — dense one-hot
    formulation, O(n_banks * chunk). Returns (done, new_bank_free)."""
    lanes = torch.arange(n_banks, dtype=bank.dtype, device=bank.device)
    onehot = bank[..., None, :] == lanes[:, None]
    arr = torch.where(onehot, arrival[..., None, :].clamp_min(_NEG), _NEG)
    srv = torch.where(onehot, service[..., None, :], 0)
    arr = torch.where(onehot, torch.maximum(arr, bank_free[..., :, None]),
                      arr)
    done_lanes = maxplus_scan(arr.to(torch.int32), srv.to(torch.int32))
    done = torch.where(onehot, done_lanes, 0).sum(dim=-2, dtype=torch.int32)
    new_free = torch.where(onehot.any(dim=-1), done_lanes[..., -1],
                           bank_free)
    return done, new_free


def segmented_cummax(m: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Running max of int32 ``m`` along the last axis that restarts
    wherever ``seg_start`` is True. Each segment is lifted above every
    earlier one by an int64 offset larger than the int32 range, so one
    plain ``cummax`` never carries a maximum across a segment boundary."""
    seg = torch.cumsum(seg_start.to(torch.int64), dim=-1)
    lift = seg << 33
    return (torch.cummax(m.to(torch.int64) + lift, dim=-1).values - lift
            ).to(torch.int32)


def segmented_maxplus_scan(arrival: torch.Tensor, service: torch.Tensor,
                           seg_start: torch.Tensor) -> torch.Tensor:
    """:func:`maxplus_scan` with the recurrence reset wherever
    ``seg_start`` is True (requires ``service >= 0``)."""
    cs = torch.cumsum(service, dim=-1, dtype=torch.int32)
    m = arrival - (cs - service)
    return segmented_cummax(m, seg_start) + cs


def resolve_bank_queues_segmented(arrival: torch.Tensor, service: torch.Tensor,
                                  bank: torch.Tensor, n_banks: int,
                                  bank_free: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bank queue resolution — stable sort by bank, one segmented
    max-plus scan, scatter back. Bitwise equal to the dense form for banks
    in range; a bank outside ``[0, n_banks)`` (a corrupt table's) reads
    ``bank_free`` under JAX's gather rule and its write is dropped, as in
    the JAX package."""
    nb = bank_free.shape[-1]
    order = torch.argsort(bank, dim=-1, stable=True)
    arr_s = arrival.clamp_min(_NEG).gather(-1, order)
    srv_s = service.gather(-1, order)
    bank_s = bank.gather(-1, order).to(torch.int64)
    head = torch.ones_like(bank_s, dtype=torch.bool)
    head[..., 1:] = bank_s[..., 1:] != bank_s[..., :-1]
    seed = bank_free.gather(-1, gather_index(bank_s, nb))
    arr_s = torch.where(head, torch.maximum(arr_s, seed), arr_s)
    done_s = segmented_maxplus_scan(arr_s, srv_s, head)
    done = torch.empty_like(done_s).scatter_(-1, order, done_s)
    wrapped = torch.where(bank_s < 0, bank_s + nb, bank_s)
    keep = (wrapped >= 0) & (wrapped < nb)
    new_free = bank_free.clone().scatter_reduce_(
        -1, torch.where(keep, wrapped, 0),
        torch.where(keep, done_s, -(2 ** 31)), "amax", include_self=True)
    return done, new_free


def pick_bank_resolver(cfg: EmulatorConfig) -> str:
    """Resolve ``cfg.bank_resolver`` ("auto": dense below 32 lanes,
    segmented from 32 lanes up)."""
    if cfg.bank_resolver != "auto":
        if cfg.bank_resolver not in ("dense", "segmented"):
            raise ValueError(
                f"unknown bank_resolver {cfg.bank_resolver!r}; expected "
                "'auto', 'dense' or 'segmented'")
        return cfg.bank_resolver
    return "segmented" if 2 * cfg.n_banks >= 32 else "dense"


def ceil_cycles(size: torch.Tensor, bytes_per_cycle: torch.Tensor
                ) -> torch.Tensor:
    """``ceil(size / bytes_per_cycle)`` as int32 for request sizes
    [..., n] and one rate per point [...]: the int32 size divided by a
    float32 tensor is an IEEE float32 quotient (a Python float here would
    make it float64 and change the rounding)."""
    if bytes_per_cycle.dtype != torch.float32:
        raise TypeError("bytes_per_cycle must be a float32 tensor")
    return torch.ceil(size / bytes_per_cycle[..., None]).to(torch.int32)


def device_service_cycles(p: RuntimeParams, device: torch.Tensor,
                          is_write: torch.Tensor,
                          size: torch.Tensor) -> torch.Tensor:
    """Media access time (latency + transfer) per request, int32: request
    vectors [..., n], ``p`` one point's fields or [...] per point."""
    lat_fast = torch.where(is_write, p.fast_write_lat[..., None],
                           p.fast_read_lat[..., None])
    lat_slow = torch.where(is_write, p.slow_write_lat[..., None],
                           p.slow_read_lat[..., None])
    xfer_fast = ceil_cycles(size, p.fast_bytes_per_cycle)
    xfer_slow = ceil_cycles(size, p.slow_bytes_per_cycle)
    return torch.where(device == SLOW, lat_slow + xfer_slow,
                       lat_fast + xfer_fast)


def link_service_cycles(p: RuntimeParams, size: torch.Tensor) -> torch.Tensor:
    """Serialization time on the host<->HMMU link (PCIe analogue)."""
    return ceil_cycles(size, p.link_bytes_per_cycle)
