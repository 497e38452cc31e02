"""Kernel B on the design-point sweep by cluster size, on one CUDA card.

Not a check of the port (``chip_smoke.py`` phase 7 is that): a measurement
for choosing how many CTAs a launch gives each point. It drives
``chip_smoke.py`` phase 7's sweep (the paper geometry, the 16-point Fig 8
grid, the ``505.mcf`` trace) and prints, each beside the card's name and
power limit:

- kernel B's device time over the first 512 chunks at B = 15, 16, 30 and
  31 points, clusters of 8 CTAs: a jump from B to B + 1 marks the number
  of clusters the card runs at once;
- the 16-point and 64-point sweeps (64: four ``hot_threshold`` values)
  over the whole trace at 8, 6, 4, 3, 2 and 1 CTAs a point, through the
  launch's ``cluster`` option, each sweep's results equal to the 8-CTA
  sweep's.

Run from the repo root: ``python3 chip_sweep_clusters.py``. Exits nonzero
without a CUDA device or when a cluster size changes a result.
"""
from __future__ import annotations

import dataclasses
import functools
import sys

import chip_smoke as cs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_sweep_clusters: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT / "src"))
    import repro_torch as rt
    from repro_torch.kernels import chunk_step
    from repro_torch.sweep import build_points

    dev = cs.cuda_device(torch)
    card = cs.card_line()
    base, spec = cs.sweep_grid(rt)
    trace = cs.sweep_trace(torch, dev, rt)
    eng = rt.Engine(base)
    spec64 = dataclasses.replace(
        spec, extra_axes=(("hot_threshold", (2, 4, 8, 16)),))
    points = build_points(spec64)
    sub = rt.core.Trace(*(x[:512 * base.chunk] for x in trace))
    waves = {b: cs.device_ms(torch, lambda b=b: eng.sweep(points[:b], sub),
                             1, "chunk_step_kernel")
             for b in (15, 16, 30, 31)}
    print("kernel B over the first 512 chunks by B, clusters of 8 (device "
          "ms): " + ", ".join(f"B={b} {ms:.3f}" for b, ms in waves.items())
          + f" [{card}]", flush=True)
    launch = chunk_step.chunk_step_cuda
    for b, grid in ((16, spec), (64, spec64)):
        times, want = {}, None
        for c in (8, 6, 4, 3, 2, 1):
            chunk_step.chunk_step_cuda = functools.partial(launch, cluster=c)
            try:
                times[c] = cs.device_ms(
                    torch, lambda: eng.sweep(grid, trace), 1,
                    "chunk_step_kernel")
                got = eng.sweep(grid, trace)
            finally:
                chunk_step.chunk_step_cuda = launch
            if want is None:
                want = got
            try:
                cs.same_runs(torch, f"B={b} with clusters of {c} against 8",
                             (got.states, got.outs),
                             (want.states, want.outs))
            except cs.Mismatch as e:
                print(f"chip_sweep_clusters: {e}", file=sys.stderr)
                return 1
        print(f"B={b} over the whole trace by CTAs a cluster (device ms; "
              "results equal): " + ", ".join(f"{c}: {ms:.3f}"
                                             for c, ms in times.items())
              + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
