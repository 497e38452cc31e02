"""The SPEC CPU 2017 workload suite of paper Table III as trace recipes
(a copy of ``repro.trace.workloads``' table, built with the port's
generators).

Footprints are the paper's measured values (Table III); per-workload
request volumes follow the paper's Fig 8 ordering. ``scale`` shrinks the
absolute request count while keeping the ratios.
"""
from __future__ import annotations

import dataclasses

from ..core.emulator import Trace
from .generators import TraceSpec, generate

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
    w = WORKLOADS[name]
    n = int(w.total_traffic_bytes * scale / 64)
    n = max(min_requests, min(max_requests, n))
    return TraceSpec(
        n_requests=n,
        footprint_pages=max(1, w.footprint_bytes // page_size),
        write_frac=w.write_frac, pattern=w.pattern, zipf_alpha=w.zipf_alpha,
        stride_pages=w.stride_pages, seq_frac=w.seq_frac,
        page_size=page_size, seed=seed)


def workload_trace(name: str, scale: float = 1e-6, page_size: int = 4096,
                   seed: int = 0, max_requests: int = 4_000_000,
                   min_requests: int = 2048, device=None
                   ) -> tuple[Trace, Workload, int]:
    """Build the trace for one workload at the given volume scale.
    Returns (trace, workload, n_requests)."""
    spec = workload_spec(name, scale, page_size, seed, max_requests,
                         min_requests)
    return generate(spec, device), WORKLOADS[name], spec.n_requests
