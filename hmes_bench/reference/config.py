"""Configuration for the hybrid-memory emulation platform (PyTorch port).

All times are integer *cycles* of the emulated HMMU clock (1 cycle == 1 ns
at the paper's 1 GHz fabric reference), mirroring the paper's stall-cycle
latency-injection mechanism (paper §III-F). The static side
(:class:`EmulatorConfig`, :func:`static_key`, :data:`TECHNOLOGIES`) is a
copy of ``repro.core.config``; :class:`RuntimeParams` holds the same
fields as 0-dim tensors on the engine's device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

# Device ids used throughout the platform.
FAST = 0  # "DRAM"  — the fast tier
SLOW = 1  # "NVM"   — the slow tier (emulated technology)


@dataclasses.dataclass(frozen=True)
class TechnologyParams:
    """Per-technology access characteristics (paper Table I).

    read/write latencies in cycles (== ns); bandwidth in bytes/cycle
    (== GB/s at 1 GHz).
    """

    name: str
    read_lat: int
    write_lat: int
    bytes_per_cycle: float
    endurance_log10: float = 16.0


@dataclasses.dataclass(frozen=True)
class EmulatorConfig:
    """Static configuration of the emulation platform (paper Table II).
    Field for field the same as ``repro.core.config.EmulatorConfig``."""

    # --- address space geometry -------------------------------------------
    page_size: int = 4096           # bytes per page (migration granularity)
    subblock: int = 512             # DMA transfer sub-block (paper §III-D)
    n_fast_pages: int = 32768       # 128 MB DRAM tier  (paper Table II)
    n_slow_pages: int = 262144      # 1 GB NVM tier     (paper Table II)
    line_size: int = 64             # request granularity after cache filtering

    # --- device timing ------------------------------------------------------
    fast: TechnologyParams = dataclasses.field(
        default_factory=lambda: TECHNOLOGIES["dram"])
    slow: TechnologyParams = dataclasses.field(
        default_factory=lambda: TECHNOLOGIES["3dxpoint"])
    n_banks: int = 16               # banks per device (queue contention model)

    # --- interconnect ("PCIe" in the paper's platform) ----------------------
    link_lat: int = 600             # per-request link round-trip overhead
    link_bytes_per_cycle: float = 8.0   # PCIe Gen3 x8 ≈ 8 GB/s

    # --- host issue model ---------------------------------------------------
    issue_gap: int = 4              # cycles between consecutive requests
    max_inflight: int = 64          # host MSHR-like cap within a chunk

    # --- DMA engine (paper §III-D) ------------------------------------------
    dma_bytes_per_cycle: float = 16.0
    dma_buffer_bytes: int = 8192

    # --- emulation pipeline -------------------------------------------------
    chunk: int = 256                # requests per pipeline chunk
    bank_resolver: str = "auto"     # "dense" | "segmented" | "auto"
    fuse_swap_gather: bool = True   # gather the DMA swap pair's rows in the
    #   same lookup-kernel launch as the chunk's pages (chunk + 2 rows)
    scan_unroll: int = 1            # part of static_key for parity with the
    #   JAX package; PyTorch runs the chunk loop eagerly, so it does nothing
    chunk_step_kernel: str = "auto"  # "auto": the CUDA chunk-step kernel for
    #   CUDA tensors, the scan path for CPU tensors; "on": the kernel (a CPU
    #   tensor raises); "off": the scan path (kernels.chunk_step)

    # --- policy -------------------------------------------------------------
    policy: str = "hotness"         # one of core.policies.POLICIES
    hot_threshold: int = 8
    hotness_decay_shift: int = 1
    decay_every: int = 16
    write_weight: int = 1           # applied only by the "write_bias" policy
    wear_slack: int = 64            # "wear_level" destination tolerance
    pin_fast_fraction: float = 0.0  # fraction of the fast tier pinned at init
    endurance_budget: int = 0       # frame retirement threshold (<= 0: off)

    # --- misc ---------------------------------------------------------------
    power_pj_per_bit_fast: float = 1.2
    power_pj_per_bit_slow_read: float = 2.0
    power_pj_per_bit_slow_write: float = 12.0

    @property
    def n_pages(self) -> int:
        return self.n_fast_pages + self.n_slow_pages

    @property
    def subblocks_per_page(self) -> int:
        return self.page_size // self.subblock

    @property
    def dma_cycles_per_subblock(self) -> int:
        return max(1, round(self.subblock / self.dma_bytes_per_cycle))

    def with_(self, **kw) -> "EmulatorConfig":
        return dataclasses.replace(self, **kw)

    def runtime(self, device=None) -> "RuntimeParams":
        return RuntimeParams.from_config(self, device=device)


def static_key(cfg: EmulatorConfig) -> tuple:
    """The fields of ``cfg`` that fix shapes and program structure; every
    other field travels in :class:`RuntimeParams`."""
    return (cfg.page_size, cfg.subblock, cfg.n_pages, cfg.line_size,
            cfg.n_banks, cfg.chunk, cfg.max_inflight, cfg.dma_buffer_bytes,
            cfg.bank_resolver, cfg.fuse_swap_gather, cfg.scan_unroll,
            cfg.chunk_step_kernel)


# RuntimeParams fields that are float32; every other field is int32.
FLOAT_PARAM_FIELDS = frozenset({
    "fast_bytes_per_cycle", "slow_bytes_per_cycle", "link_bytes_per_cycle",
    "pin_fast_fraction", "power_pj_per_bit_fast",
    "power_pj_per_bit_slow_read", "power_pj_per_bit_slow_write"})


class RuntimeParams(NamedTuple):
    """Runtime parameters of one design point: 0-dim int32 tensors, and
    float32 for :data:`FLOAT_PARAM_FIELDS`, all on one device. Field names
    and order are those of ``repro.core.config.RuntimeParams`` (the
    chunk-step kernel's scalar vector follows this order)."""

    fast_read_lat: torch.Tensor
    fast_write_lat: torch.Tensor
    fast_bytes_per_cycle: torch.Tensor
    slow_read_lat: torch.Tensor
    slow_write_lat: torch.Tensor
    slow_bytes_per_cycle: torch.Tensor
    link_lat: torch.Tensor
    link_bytes_per_cycle: torch.Tensor
    issue_gap: torch.Tensor
    dma_cycles_per_subblock: torch.Tensor
    n_fast_pages: torch.Tensor
    hot_threshold: torch.Tensor
    hotness_decay_shift: torch.Tensor
    decay_every: torch.Tensor
    write_weight: torch.Tensor
    wear_slack: torch.Tensor
    pin_fast_fraction: torch.Tensor
    endurance_budget: torch.Tensor
    policy_id: torch.Tensor
    power_pj_per_bit_fast: torch.Tensor
    power_pj_per_bit_slow_read: torch.Tensor
    power_pj_per_bit_slow_write: torch.Tensor

    @classmethod
    def from_config(cls, cfg: EmulatorConfig, device=None,
                    policy_id: int | None = None) -> "RuntimeParams":
        """The config's design point. ``policy_id`` defaults to the
        policy's index among the built-in policies."""
        if policy_id is None:
            from . import policies  # deferred; policies imports this module
            policy_id = policies.policy_id(cfg.policy)
        vals = dict(
            fast_read_lat=cfg.fast.read_lat,
            fast_write_lat=cfg.fast.write_lat,
            fast_bytes_per_cycle=cfg.fast.bytes_per_cycle,
            slow_read_lat=cfg.slow.read_lat,
            slow_write_lat=cfg.slow.write_lat,
            slow_bytes_per_cycle=cfg.slow.bytes_per_cycle,
            link_lat=cfg.link_lat,
            link_bytes_per_cycle=cfg.link_bytes_per_cycle,
            issue_gap=cfg.issue_gap,
            dma_cycles_per_subblock=cfg.dma_cycles_per_subblock,
            n_fast_pages=cfg.n_fast_pages,
            hot_threshold=cfg.hot_threshold,
            hotness_decay_shift=cfg.hotness_decay_shift,
            decay_every=cfg.decay_every,
            write_weight=cfg.write_weight,
            wear_slack=cfg.wear_slack,
            pin_fast_fraction=cfg.pin_fast_fraction,
            endurance_budget=cfg.endurance_budget,
            policy_id=policy_id,
            power_pj_per_bit_fast=cfg.power_pj_per_bit_fast,
            power_pj_per_bit_slow_read=cfg.power_pj_per_bit_slow_read,
            power_pj_per_bit_slow_write=cfg.power_pj_per_bit_slow_write,
        )
        return cls(**{
            k: torch.tensor(v, dtype=torch.float32 if k in FLOAT_PARAM_FIELDS
                            else torch.int32, device=device)
            for k, v in vals.items()})

    def with_(self, **kw) -> "RuntimeParams":
        return self._replace(**kw)


# Paper Table I, converted to cycles (ns) and bytes/cycle.
TECHNOLOGIES: dict[str, TechnologyParams] = {
    "dram": TechnologyParams("dram", read_lat=50, write_lat=50,
                             bytes_per_cycle=19.2, endurance_log10=16),
    "3dxpoint": TechnologyParams("3dxpoint", read_lat=100, write_lat=275,
                                 bytes_per_cycle=2.4, endurance_log10=9),
    "stt-ram": TechnologyParams("stt-ram", read_lat=20, write_lat=20,
                                bytes_per_cycle=12.8, endurance_log10=16),
    "mram": TechnologyParams("mram", read_lat=20, write_lat=20,
                             bytes_per_cycle=12.8, endurance_log10=15),
    "flash": TechnologyParams("flash", read_lat=100_000, write_lat=100_000,
                              bytes_per_cycle=0.5, endurance_log10=4),
    "hdd": TechnologyParams("hdd", read_lat=5_000_000, write_lat=5_000_000,
                            bytes_per_cycle=0.15, endurance_log10=15),
}


def paper_platform() -> EmulatorConfig:
    """The exact platform of paper Table II: 128 MB DRAM + 1 GB emulated
    3D XPoint behind a PCIe Gen3 link."""
    return EmulatorConfig()


def small_platform(**kw) -> EmulatorConfig:
    """A reduced platform for tests: tiny page counts, small chunks."""
    base = dict(n_fast_pages=8, n_slow_pages=56, chunk=16, hot_threshold=3)
    base.update(kw)
    return EmulatorConfig(**base)
