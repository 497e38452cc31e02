"""The benchmark's traffic generator: synthetic post-cache memory traces
drawn on the CPU from a seed, and the SPEC CPU 2017 recipe table of paper
Table III (footprints) and Fig 8 (request volumes).

A frozen copy of the program's generator and recipe table: later changes
to the program do not move the benchmark's traffic. A seed gives the same
trace on every machine.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


class Trace(NamedTuple):
    """A memory-request trace on the CPU (struct of 1-D tensors)."""
    page: torch.Tensor      # int32 flat page number
    offset: torch.Tensor    # int32 byte offset within the page
    is_write: torch.Tensor  # bool
    size: torch.Tensor      # int32 bytes (the 64 B line)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Recipe for a synthetic request stream."""
    n_requests: int
    footprint_pages: int         # working-set size in pages
    write_frac: float = 0.3
    pattern: str = "zipfian"     # zipfian | sequential | strided | pointer
    #                            # | mixed
    zipf_alpha: float = 1.1
    stride_pages: int = 2
    seq_frac: float = 0.5        # for `mixed`: fraction of sequential traffic
    line: int = 64
    page_size: int = 4096
    seed: int = 0


def _gen(spec: TraceSpec, salt: int) -> torch.Generator:
    return torch.Generator().manual_seed(spec.seed * 1009 + salt)


def _writes(spec, g) -> torch.Tensor:
    return torch.rand(spec.n_requests, generator=g) < spec.write_frac


def _offsets(spec, g) -> torch.Tensor:
    lines = spec.page_size // spec.line
    return (torch.randint(0, lines, (spec.n_requests,), generator=g)
            * spec.line).to(torch.int32)


def _sizes(spec) -> torch.Tensor:
    return torch.full((spec.n_requests,), spec.line, dtype=torch.int32)


def _zipf_pages(g, n, footprint, alpha) -> torch.Tensor:
    """Zipfian page popularity by inverse-CDF sampling on ranks, with the
    ranks scattered over the footprint so hot pages are not contiguous."""
    ranks = torch.arange(1, footprint + 1, dtype=torch.float64)
    cdf = torch.cumsum(ranks ** -alpha, 0)
    cdf = cdf / cdf[-1]
    u = torch.rand(n, generator=g, dtype=torch.float64)
    pages = torch.searchsorted(cdf, u).clamp_max(footprint - 1)
    perm = torch.randperm(footprint, generator=g)
    return perm[pages].to(torch.int32)


def zipfian(spec: TraceSpec) -> Trace:
    return Trace(
        page=_zipf_pages(_gen(spec, 1), spec.n_requests,
                         spec.footprint_pages, spec.zipf_alpha),
        offset=_offsets(spec, _gen(spec, 2)),
        is_write=_writes(spec, _gen(spec, 3)),
        size=_sizes(spec))


def sequential(spec: TraceSpec) -> Trace:
    lines = spec.page_size // spec.line
    idx = torch.arange(spec.n_requests, dtype=torch.int64)
    return Trace(page=((idx // lines) % spec.footprint_pages).to(torch.int32),
                 offset=((idx % lines) * spec.line).to(torch.int32),
                 is_write=_writes(spec, _gen(spec, 3)),
                 size=_sizes(spec))


def strided(spec: TraceSpec) -> Trace:
    idx = torch.arange(spec.n_requests, dtype=torch.int64)
    page = (idx * spec.stride_pages) % spec.footprint_pages
    return Trace(page=page.to(torch.int32),
                 offset=_offsets(spec, _gen(spec, 2)),
                 is_write=_writes(spec, _gen(spec, 3)),
                 size=_sizes(spec))


def pointer_chase(spec: TraceSpec) -> Trace:
    """Random-walk page chain: each access a hash of the previous page
    (int32 arithmetic, floor modulo — the JAX package's chain exactly)."""
    fp = spec.footprint_pages
    page = np.empty(spec.n_requests, np.int32)
    p = 1
    for i in range(spec.n_requests):
        x = (p * 1103515245) & 0xFFFFFFFF           # int32 wrap
        x = ((x + 12345 + i + 0x80000000) & 0xFFFFFFFF) - 0x80000000
        p = x % fp
        page[i] = p
    return Trace(page=torch.from_numpy(page),
                 offset=_offsets(spec, _gen(spec, 2)),
                 is_write=_writes(spec, _gen(spec, 3)),
                 size=_sizes(spec))


def mixed(spec: TraceSpec) -> Trace:
    """Interleave sequential streaming with zipfian reuse traffic."""
    z = zipfian(spec)
    s = sequential(spec)
    pick_seq = torch.rand(spec.n_requests, generator=_gen(spec, 99)) < \
        spec.seq_frac
    return Trace(*(torch.where(pick_seq, a, b) for a, b in zip(s, z)))


_PATTERNS = {"zipfian": zipfian, "sequential": sequential, "strided": strided,
             "pointer": pointer_chase, "mixed": mixed}


def generate(spec: TraceSpec) -> Trace:
    """The trace for ``spec``, drawn on the CPU."""
    return _PATTERNS[spec.pattern](spec)


_MB = 1 << 20
_GB = 1 << 30
_TB = 1 << 40


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    footprint_bytes: int
    total_traffic_bytes: float   # read + write volume at paper scale (Fig 8)
    write_frac: float
    pattern: str
    zipf_alpha: float = 1.1
    stride_pages: int = 2
    seq_frac: float = 0.5


WORKLOADS: dict[str, Workload] = {w.name: w for w in [
    # --- integer -----------------------------------------------------------
    Workload("500.perlbench", 202 * _MB, 120 * _GB, 0.45, "zipfian", 1.2),
    Workload("505.mcf", 602 * _MB, 5.65 * _TB, 0.50, "zipfian", 0.9),
    Workload("508.namd", 172 * _MB, 40 * _GB, 0.35, "strided", stride_pages=3),
    Workload("520.omnetpp", 241 * _MB, 800 * _GB, 0.45, "zipfian", 1.0),
    Workload("523.xalancbmk", 481 * _MB, 600 * _GB, 0.40, "pointer"),
    Workload("525.x264", 165 * _MB, 60 * _GB, 0.40, "mixed", seq_frac=0.8),
    Workload("531.deepsjeng", 700 * _MB, 50 * _GB, 0.45, "zipfian", 1.3),
    Workload("541.leela", 22 * _MB, 10 * _GB, 0.45, "zipfian", 1.3),
    Workload("557.xz", 727 * _MB, 500 * _GB, 0.50, "mixed", seq_frac=0.6),
    # --- floating point ----------------------------------------------------
    Workload("519.lbm", 410 * _MB, 1.5 * _TB, 0.50, "sequential"),
    Workload("538.imagick", 287 * _MB, 8.96 * _GB, 0.50, "mixed", seq_frac=0.8),
    Workload("544.nab", 147 * _MB, 30 * _GB, 0.35, "strided", stride_pages=5),
]}


def workload_spec(name: str, scale: float = 1e-6, page_size: int = 4096,
                  seed: int = 0, max_requests: int = 4_000_000,
                  min_requests: int = 2048) -> TraceSpec:
    """The :class:`TraceSpec` of one workload at ``scale``; the request
    count is clamped to [min_requests, max_requests]."""
    return recipe_spec(WORKLOADS[name], scale, page_size, seed, max_requests,
                       min_requests)


def recipe_spec(w: Workload, scale: float = 1e-6, page_size: int = 4096,
                seed: int = 0, max_requests: int = 4_000_000,
                min_requests: int = 2048) -> TraceSpec:
    """:func:`workload_spec` of a recipe that need not be in the table."""
    n = int(w.total_traffic_bytes * scale / 64)
    n = max(min_requests, min(max_requests, n))
    return TraceSpec(
        n_requests=n,
        footprint_pages=max(1, w.footprint_bytes // page_size),
        write_frac=w.write_frac, pattern=w.pattern, zipf_alpha=w.zipf_alpha,
        stride_pages=w.stride_pages, seq_frac=w.seq_frac,
        page_size=page_size, seed=seed)
