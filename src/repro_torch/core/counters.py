"""Performance counters (paper §II-B, Fig 8), PyTorch port of
``repro.core.counters``.

Counts are int32; bytes, the read-latency sum and energy are float32.
The update keeps the JAX package's order of operations: each chunk's
sums first, then ``c + s`` in float32. A chunk's bytes and read latencies
are integers: their sum is taken exactly (int64) and rounded to float32
once. That is the JAX package's float32 sum wherever that sum is exact
(a chunk's integer sum below 2^24: the golden digests, the main trace),
and it does not depend on the order of the additions, so the CPU, the
card's plain version and the chunk-step kernel agree bit for bit; above
2^24 the JAX package's float32 sum depends on XLA's order of additions.

Energy follows the reference as it runs, under ``jit``: XLA fuses the
energy expression into two fused multiply-adds,
``fma(8*bws, p_sw, fma(bits_fast, p_f, (8*brs) * p_sr))``, then adds it
to the counter with a plain float32 ``+``. Eager PyTorch never contracts
``a*b + c``, so :func:`fma` rounds it once by hand, with the same ops on
the CPU and on the card; the chunk-step kernel uses ``__fmaf_rn`` in the
same order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import telemetry
from .config import SLOW


class Counters(NamedTuple):
    reads_fast: torch.Tensor        # int32 counts
    writes_fast: torch.Tensor
    reads_slow: torch.Tensor
    writes_slow: torch.Tensor
    bytes_read_fast: torch.Tensor   # float32
    bytes_write_fast: torch.Tensor
    bytes_read_slow: torch.Tensor
    bytes_write_slow: torch.Tensor
    sum_read_latency: torch.Tensor  # float32, cycles over read requests
    n_reads: torch.Tensor           # int32
    max_latency: torch.Tensor       # int32
    reorder_held: torch.Tensor      # int32 — responses delayed by tag match
    energy_pj: torch.Tensor         # float32 — dynamic energy estimate
    poison_faults: torch.Tensor     # int32 — accesses to POISONED pages
    frames_retired: torch.Tensor    # int32 — frames taken out of service
    transient_faults: torch.Tensor  # int32 — FaultPlan transient injections

    @staticmethod
    def zeros(device=None) -> "Counters":
        vals = []
        for name in Counters._fields:
            dt = torch.float32 if name in FLOAT_FIELDS else torch.int32
            vals.append(torch.zeros((), dtype=dt, device=device))
        return Counters(*vals)


FLOAT_FIELDS = frozenset({
    "bytes_read_fast", "bytes_write_fast", "bytes_read_slow",
    "bytes_write_slow", "sum_read_latency", "energy_pj"})


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for float32 tensors, rounded once to float32 (IEEE
    fusedMultiplyAdd, round to nearest even).

    The product of two float32 is exact in float64; the float64 sum is
    rounded to odd (its TwoSum error folded into the last bit: of the
    two doubles around the exact sum, the one whose last bit is 1), and
    53 bits rounded to odd round to 24 bits exactly as the exact sum
    would, so the final cast is the only rounding that shows."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    prod = a64 * b64
    s = prod + c64
    bb = s - prod
    err = (prod - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def update(p, c: Counters, *, device: torch.Tensor,
           is_write: torch.Tensor, size: torch.Tensor, valid: torch.Tensor,
           latency: torch.Tensor, held: torch.Tensor,
           poisoned: torch.Tensor | None = None,
           retired: torch.Tensor | None = None,
           injected: torch.Tensor | None = None) -> Counters:
    """Accumulate one chunk. Request fields are [chunk] tensors; ``p`` is
    a ``RuntimeParams`` (float32 power coefficients); ``poisoned`` and
    ``injected`` are bool masks, ``retired`` a bool/int count. With a
    leading point axis (request fields [B, chunk], ``p``, ``c``, ``held``
    and ``retired`` [B]) each point's chunk folds into its own counters."""
    v = valid
    w = is_write & v
    r = (~is_write) & v
    slow = device == SLOW

    def cnt(mask):
        return mask.sum(dim=-1, dtype=torch.int32)

    def exact_sum(mask, x):
        return torch.where(mask, x, 0).sum(dim=-1, dtype=torch.int64).to(
            torch.float32)

    def byt(mask):
        return exact_sum(mask, size)

    bits_fast = 8.0 * (byt(r & ~slow) + byt(w & ~slow))
    energy = fma(8.0 * byt(w & slow), p.power_pj_per_bit_slow_write,
                 fma(bits_fast, p.power_pj_per_bit_fast,
                     8.0 * byt(r & slow) * p.power_pj_per_bit_slow_read))

    lat_max = torch.where(v, latency, 0).amax(dim=-1)
    return Counters(
        reads_fast=c.reads_fast + cnt(r & ~slow),
        writes_fast=c.writes_fast + cnt(w & ~slow),
        reads_slow=c.reads_slow + cnt(r & slow),
        writes_slow=c.writes_slow + cnt(w & slow),
        bytes_read_fast=c.bytes_read_fast + byt(r & ~slow),
        bytes_write_fast=c.bytes_write_fast + byt(w & ~slow),
        bytes_read_slow=c.bytes_read_slow + byt(r & slow),
        bytes_write_slow=c.bytes_write_slow + byt(w & slow),
        sum_read_latency=c.sum_read_latency + exact_sum(r, latency),
        n_reads=c.n_reads + cnt(r),
        max_latency=torch.maximum(c.max_latency, lat_max),
        reorder_held=c.reorder_held + held,
        energy_pj=c.energy_pj + energy,
        poison_faults=c.poison_faults +
        (0 if poisoned is None else cnt(poisoned)),
        frames_retired=c.frames_retired +
        (0 if retired is None else retired.to(torch.int32)),
        transient_faults=c.transient_faults +
        (0 if injected is None else cnt(injected)),
    )


def summary(c: Counters) -> dict:
    """Host-side readable summary (Python numbers)."""
    with telemetry.span("counters.summary"):
        return _summary(c)


def _summary(c: Counters) -> dict:
    g = lambda x: x.item() if hasattr(x, "item") else x
    n_reads = max(1, g(c.n_reads))
    return {
        "reads_fast": g(c.reads_fast), "writes_fast": g(c.writes_fast),
        "reads_slow": g(c.reads_slow), "writes_slow": g(c.writes_slow),
        "GB_read": (g(c.bytes_read_fast) + g(c.bytes_read_slow)) / 1e9,
        "GB_written": (g(c.bytes_write_fast) + g(c.bytes_write_slow)) / 1e9,
        "mean_read_latency_cyc": g(c.sum_read_latency) / n_reads,
        "max_latency_cyc": g(c.max_latency),
        "reorder_held": g(c.reorder_held),
        "energy_mJ": g(c.energy_pj) / 1e9,
        "poison_faults": g(c.poison_faults),
        "frames_retired": g(c.frames_retired),
        "transient_faults": g(c.transient_faults),
    }
