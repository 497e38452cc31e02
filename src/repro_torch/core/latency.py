"""Latency model: stall-cycle injection (paper §III-F), PyTorch port of
``repro.core.latency``.

Every request gets ``service = device latency + transfer + bank-queue
wait + link``. Queue contention inside a chunk is resolved exactly by the
max-plus recurrence ``done_i = max(arrival_i, done_{prev}) + service_i``
in closed form: ``done_i = cummax_j(arr_j - CS_{j-1}) + CS_i`` with
``CS = cumsum(service)``, all in int32.
"""
from __future__ import annotations

import torch

from .config import EmulatorConfig, RuntimeParams, SLOW

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
    onehot = bank[None, :] == lanes[:, None]
    arr = torch.where(onehot, arrival[None, :].clamp_min(_NEG), _NEG)
    srv = torch.where(onehot, service[None, :], 0)
    arr = torch.where(onehot, torch.maximum(arr, bank_free[:, None]), arr)
    done_lanes = maxplus_scan(arr.to(torch.int32), srv.to(torch.int32))
    done = torch.where(onehot, done_lanes, 0).sum(dim=0, dtype=torch.int32)
    new_free = torch.where(onehot.any(dim=1), done_lanes[:, -1], bank_free)
    return done, new_free


def segmented_cummax(m: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Running max of int32 ``m`` that restarts wherever ``seg_start`` is
    True (1-D). Each segment is lifted above every earlier one by an int64
    offset larger than the int32 range, so one plain ``cummax`` never
    carries a maximum across a segment boundary."""
    seg = torch.cumsum(seg_start.to(torch.int64), dim=0)
    lift = seg << 33
    return (torch.cummax(m.to(torch.int64) + lift, dim=0).values - lift
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
    max-plus scan, scatter back. Bitwise equal to the dense form."""
    order = torch.argsort(bank, stable=True)
    arr_s = arrival.clamp_min(_NEG)[order]
    srv_s = service[order]
    bank_s = bank[order].to(torch.int64)
    head = torch.ones_like(bank_s, dtype=torch.bool)
    head[1:] = bank_s[1:] != bank_s[:-1]
    arr_s = torch.where(head, torch.maximum(arr_s, bank_free[bank_s]), arr_s)
    done_s = segmented_maxplus_scan(arr_s, srv_s, head)
    done = torch.empty_like(done_s)
    done[order] = done_s
    new_free = bank_free.clone().scatter_reduce_(0, bank_s, done_s, "amax",
                                                 include_self=True)
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
    """``ceil(size / bytes_per_cycle)`` as int32: the int32 size divided
    by a float32 0-dim tensor is an IEEE float32 quotient (a Python float
    here would make it float64 and change the rounding)."""
    if bytes_per_cycle.dtype != torch.float32:
        raise TypeError("bytes_per_cycle must be a float32 tensor")
    return torch.ceil(size / bytes_per_cycle).to(torch.int32)


def device_service_cycles(p: RuntimeParams, device: torch.Tensor,
                          is_write: torch.Tensor,
                          size: torch.Tensor) -> torch.Tensor:
    """Media access time (latency + transfer) per request, int32."""
    lat_fast = torch.where(is_write, p.fast_write_lat, p.fast_read_lat)
    lat_slow = torch.where(is_write, p.slow_write_lat, p.slow_read_lat)
    xfer_fast = ceil_cycles(size, p.fast_bytes_per_cycle)
    xfer_slow = ceil_cycles(size, p.slow_bytes_per_cycle)
    return torch.where(device == SLOW, lat_slow + xfer_slow,
                       lat_fast + xfer_fast)


def link_service_cycles(p: RuntimeParams, size: torch.Tensor) -> torch.Tensor:
    """Serialization time on the host<->HMMU link (PCIe analogue)."""
    return ceil_cycles(size, p.link_bytes_per_cycle)
