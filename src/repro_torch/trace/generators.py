"""Synthetic memory-trace generators (PyTorch port of
``repro.trace.generators``).

Post-cache-filter request streams with the access-pattern families that
dominate SPEC CPU 2017: zipfian reuse, sequential streaming, strided,
pointer chasing, and the ``mixed`` composition. The
distributions are the JAX package's; the random bits are not (a
``torch.Generator`` seeded with ``spec.seed`` draws them), so parity
tests feed both packages the same numpy-built traces instead. The
deterministic parts (sequential and strided pages, the pointer chain)
are equal to the JAX package's element for element.

Traces are drawn on the CPU, so a seed gives the same trace on every
device, and then moved to ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.emulator import Trace


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


def generate(spec: TraceSpec, device=None) -> Trace:
    """The trace for ``spec`` on ``device`` (drawn on the CPU)."""
    t = _PATTERNS[spec.pattern](spec)
    return t if device is None else t.to(device)
