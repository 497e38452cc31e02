"""Synthetic memory-trace generators (PyTorch port of
``repro.trace.generators``).

Post-cache-filter request streams with the access-pattern families that
dominate SPEC CPU 2017: zipfian reuse, sequential streaming, strided,
pointer chasing, the ``mixed`` composition, and ``serve_mixed``
(multi-tenant prefill/decode serving traffic). The
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
from typing import NamedTuple

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
    #                            # | mixed | serve_mixed
    zipf_alpha: float = 1.1
    stride_pages: int = 2
    seq_frac: float = 0.5        # for `mixed`: fraction of sequential traffic
    n_tenants: int = 4           # for `serve_mixed`: concurrent tenants
    prefill_frac: float = 0.2    # for `serve_mixed`: prefill share of traffic
    decode_window: int = 8       # for `serve_mixed`: decode window, pages
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


class ServeDraws(NamedTuple):
    """The random draws of :func:`serve_mixed`, one per request."""
    tenant: torch.Tensor        # int64 tenant of the request
    is_prefill: torch.Tensor    # bool: a prefill (else a decode) request
    delta: torch.Tensor         # int64 decode distance behind the frontier
    decode_write: torch.Tensor  # bool: a decode token write, if delta == 0


def serve_draws(spec: TraceSpec) -> ServeDraws:
    n = spec.n_requests
    return ServeDraws(
        tenant=torch.randint(0, spec.n_tenants, (n,), generator=_gen(spec, 5)),
        is_prefill=torch.rand(n, generator=_gen(spec, 6)) < spec.prefill_frac,
        delta=torch.randint(0, spec.decode_window, (n,),
                            generator=_gen(spec, 7)),
        decode_write=torch.rand(n, generator=_gen(spec, 8)) < spec.write_frac)


def serve_mixed(spec: TraceSpec) -> Trace:
    """Multi-tenant mixed prefill/decode serving traffic: ``n_tenants``
    tenants share the footprint in equal slices; a ``prefill_frac`` share
    of requests are prefill writes marching the tenant's slice forward
    (its frontier: the running count of its prefill requests, this one
    included), the rest decode reads ``delta`` pages behind the frontier
    (floored at 0), with a token write at ``delta == 0`` at the usual
    ``write_frac``."""
    t, w = spec.n_tenants, serve_draws(spec)
    per = max(spec.footprint_pages // t, 1)
    onehot = (w.tenant[:, None] == torch.arange(t)[None, :]) \
        & w.is_prefill[:, None]
    frontier = onehot.to(torch.int64).cumsum(0).gather(
        1, w.tenant[:, None])[:, 0]
    page_decode = (frontier - 1 - w.delta).clamp_min(0) % per
    page = w.tenant * per + torch.where(w.is_prefill, frontier % per,
                                        page_decode)
    is_write = w.is_prefill | (w.decode_write & (w.delta == 0))
    return Trace(page=page.to(torch.int32),
                 offset=_offsets(spec, _gen(spec, 2)), is_write=is_write,
                 size=_sizes(spec))


_PATTERNS = {"zipfian": zipfian, "sequential": sequential, "strided": strided,
             "pointer": pointer_chase, "mixed": mixed,
             "serve_mixed": serve_mixed}


def generate(spec: TraceSpec, device=None) -> Trace:
    """The trace for ``spec`` on ``device`` (drawn on the CPU)."""
    t = _PATTERNS[spec.pattern](spec)
    return t if device is None else t.to(device)
