"""Traces whose footprint passes the largest of the recipe table
(557.xz's 727 MB): :mod:`tracegen`'s zipfian draw without a tensor the
size of the footprint.

``tracegen._zipf_pages`` builds a float64 CDF and a ``randperm`` over
the whole footprint: 16 bytes a page, some 6.4 GB and tens of seconds a
trace at 4 x 10^8 pages. Here a rank is drawn by rejection-inversion
(W. Hörmann and G. Derflinger, "Rejection-inversion to generate variates
from monotone discrete distributions", ACM TOMACS 6(3), 1996; the
sampler of Apache Commons' ``ZipfDistribution``), which is exact for
P(k) proportional to k^-alpha on 1..F at a few float64 operations a
request, and the ranks are scattered over the footprint by a keyed
Feistel permutation of [0, F), cycle-walked, which needs no table. Time
and memory grow with the request count alone.

:func:`generate` takes this path only past :data:`TABLE_FOOTPRINT_BYTES`:
every recipe the table reaches keeps :mod:`tracegen`'s draw, bit for
bit. A seed gives the same trace on one machine; across machines the
ranks rest on float64 ``log1p`` / ``expm1``, which a platform may round
differently in the last place (it moves a rank only where a draw falls
within an ulp of a rank's edge).
"""
from __future__ import annotations

import math

import torch

from hmes_bench import tracegen

# The largest footprint of the recipe table; a trace at or below it is
# :mod:`tracegen`'s.
TABLE_FOOTPRINT_BYTES = max(w.footprint_bytes
                            for w in tracegen.WORKLOADS.values())
FEISTEL_ROUNDS = 6
_M32 = 0xFFFFFFFF


def _log1p_over(t: torch.Tensor) -> torch.Tensor:
    """log1p(t) / t, 1 at t = 0 (Commons' ``helper1``)."""
    small = t.abs() <= 1e-8
    safe = torch.where(small, torch.ones_like(t), t)
    return torch.where(small, 1 - t * (0.5 - t * (1 / 3 - 0.25 * t)),
                       torch.log1p(safe) / safe)


def _expm1_over(t: torch.Tensor) -> torch.Tensor:
    """expm1(t) / t, 1 at t = 0 (Commons' ``helper2``)."""
    small = t.abs() <= 1e-8
    safe = torch.where(small, torch.ones_like(t), t)
    return torch.where(small, 1 + t * 0.5 * (1 + t / 3 * (1 + 0.25 * t)),
                       torch.expm1(safe) / safe)


class _Zipf:
    """The rejection-inversion sampler of Zipf(``alpha``) on
    1..``footprint``: H is an integral of h(x) = x^-alpha, and a draw
    inverts H at a uniform point and keeps the nearest integer k unless it
    falls outside h's area over [k - 1/2, k + 1/2]."""

    def __init__(self, footprint: int, alpha: float):
        self.alpha = alpha
        t = lambda x: torch.tensor(x, dtype=torch.float64)
        self.h_x1 = float(self.big_h(t(1.5))) - 1.0
        self.h_n = float(self.big_h(t(footprint + 0.5)))
        self.s = 2.0 - float(self.big_h_inv(self.big_h(t(2.5))
                                            - self.h(t(2.0))))
        self.footprint = footprint

    def h(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(-self.alpha * torch.log(x))

    def big_h(self, x: torch.Tensor) -> torch.Tensor:
        lx = torch.log(x)
        return _expm1_over((1 - self.alpha) * lx) * lx

    def big_h_inv(self, x: torch.Tensor) -> torch.Tensor:
        t = (x * (1 - self.alpha)).clamp_min(-1.0)
        return torch.exp(_log1p_over(t) * x)

    def ranks(self, g: torch.Generator, n: int) -> torch.Tensor:
        """int64[n]: ranks 1..footprint; each round redraws, in order,
        the requests the last one rejected."""
        out = torch.empty(n, dtype=torch.int64)
        todo = torch.arange(n)
        while len(todo):
            u = self.h_n + torch.rand(len(todo), generator=g,
                                      dtype=torch.float64) * (
                self.h_x1 - self.h_n)
            x = self.big_h_inv(u)
            k = torch.floor(x + 0.5).clamp(1, self.footprint)
            ok = (k - x <= self.s) | (u >= self.big_h(k + 0.5) - self.h(k))
            out[todo[ok]] = k[ok].to(torch.int64)
            todo = todo[~ok]
        return out


def zipf_ranks(g: torch.Generator, n: int, footprint: int,
               alpha: float) -> torch.Tensor:
    """int64[n]: ranks 0..footprint-1 drawn from Zipf(``alpha``), rank 0
    the most popular."""
    return _Zipf(footprint, alpha).ranks(g, n) - 1


def _mix(x: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of ``x`` under ``key`` (int64 tensors below
    2^32; every product stays below 2^63)."""
    x = (x ^ key) & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def _feistel(x: torch.Tensor, keys: list, half: int) -> torch.Tensor:
    """A permutation of [0, 2^(2 half)): balanced Feistel rounds over
    halves of ``half`` bits."""
    mask = (1 << half) - 1
    left, right = x >> half, x & mask
    for k in keys:
        left, right = right, left ^ (_mix(right, k) & mask)
    return (left << half) | right


def scatter(ranks: torch.Tensor, footprint: int,
            keys: list) -> torch.Tensor:
    """int64: each rank's page, a bijection of [0, ``footprint``) keyed by
    ``keys``: the Feistel permutation of the smallest even power of two
    that holds the footprint, applied again to a value outside it until it
    falls inside (cycle walking)."""
    half = max(1, ((footprint - 1).bit_length() + 1) // 2)
    out = _feistel(ranks, keys, half)
    out_of = (out >= footprint).nonzero().flatten()
    while len(out_of):
        out[out_of] = _feistel(out[out_of], keys, half)
        out_of = out_of[out[out_of] >= footprint]
    return out


def _zipf_pages(g, n, footprint, alpha) -> torch.Tensor:
    """``tracegen._zipf_pages``'s distribution, drawn from ``g`` without
    a tensor of the footprint's size."""
    ranks = zipf_ranks(g, n, footprint, alpha)
    keys = torch.randint(0, 1 << 32, (FEISTEL_ROUNDS,), generator=g)
    return scatter(ranks, footprint, keys.tolist()).to(torch.int32)


def zipfian(spec: tracegen.TraceSpec) -> tracegen.Trace:
    return tracegen.Trace(
        page=_zipf_pages(tracegen._gen(spec, 1), spec.n_requests,
                         spec.footprint_pages, spec.zipf_alpha),
        offset=tracegen._offsets(spec, tracegen._gen(spec, 2)),
        is_write=tracegen._writes(spec, tracegen._gen(spec, 3)),
        size=tracegen._sizes(spec))


def mixed(spec: tracegen.TraceSpec) -> tracegen.Trace:
    """``tracegen.mixed`` with this module's zipfian half."""
    z = zipfian(spec)
    s = tracegen.sequential(spec)
    pick_seq = torch.rand(spec.n_requests,
                          generator=tracegen._gen(spec, 99)) < spec.seq_frac
    return tracegen.Trace(*(torch.where(pick_seq, a, b)
                            for a, b in zip(s, z)))


_PATTERNS = {"zipfian": zipfian, "mixed": mixed}


def generate(spec: tracegen.TraceSpec) -> tracegen.Trace:
    """The trace for ``spec``: :func:`tracegen.generate`'s up to the
    table's largest footprint; past it, the zipfian draw (alone or as the
    half of ``mixed``) of this module."""
    if spec.footprint_pages * spec.page_size <= TABLE_FOOTPRINT_BYTES:
        return tracegen.generate(spec)
    return _PATTERNS.get(spec.pattern, tracegen.generate)(spec)
