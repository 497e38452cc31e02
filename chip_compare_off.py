#!/usr/bin/env python3
"""Time the emulator's scan path (``chunk_step_kernel="off"``) of two
checkouts on one CUDA card, in turns.

Run from the root of a checkout, with one CUDA device visible:

    python3 chip_compare_off.py OTHER_SRC [--rounds N]

``OTHER_SRC`` is the ``src`` directory of another checkout (for example a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). The two sides run in the order other, this, this,
other, repeated ``N`` times (default 1), each in a process of its own, so
both packages (each named ``repro_torch``) meet the same card in turns.
Each run times, on the host clock around calls that end in
``torch.cuda.synchronize()``, after a short warm-up of each:

* ``Engine.run`` on ``"off"`` over phase 5's whole main path
  (``520.omnetpp`` at scale 1e-4, 2,622 chunks, ``paper_platform()`` with
  ``chunk=512``, ``hotness``, ``hot_threshold=4``), as phase 5 runs it;
* ``Engine.sweep`` on ``"off"`` over the first 64 chunks of phase 7's
  sweep (``505.mcf`` at scale 1e-5, the 16-point Fig 8 grid).

It prints one JSON line a run (seconds and kernel-A launches of each
call), then the card's name and power limit. A measurement, not a check:
it exits nonzero only when a run fails or there is no CUDA device.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent

CHILD = r'''
import dataclasses, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import repro_torch as rt
from repro_torch.kernels import hmmu_lookup as hl
from repro_torch.trace import workload_trace
import chip_smoke as cs

dev = cs.cuda_device(torch)
chunk = 512


def head(trace, n_chunks):
    return rt.core.Trace(*(x[:n_chunks * chunk] for x in trace))


def timed(fn, warm):
    warm()
    torch.cuda.synchronize()
    hl.KERNEL.launches = 0
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, hl.KERNEL.launches


cfg = rt.paper_platform().with_(chunk=chunk, policy="hotness",
                                hot_threshold=4, chunk_step_kernel="off")
main, _, _ = workload_trace("520.omnetpp", scale=1e-4, device=dev)
eng = rt.Engine(cfg)
run_s, run_launches = timed(lambda: eng.run(main),
                            lambda: eng.run(head(main, 4)))
base, spec = cs.sweep_grid(rt)
off = base.with_(chunk_step_kernel="off")
spec = dataclasses.replace(spec, base=off)
mcf, _, _ = workload_trace("505.mcf", scale=1e-5, device=dev)
sweep = rt.Engine(off)
sweep_s, sweep_launches = timed(lambda: sweep.sweep(spec, head(mcf, 64)),
                                lambda: sweep.sweep(spec, head(mcf, 2)))
print(json.dumps({"src": sys.argv[1], "run_s": run_s,
                  "run_launches": run_launches,
                  "sweep_16_points_64_chunks_s": sweep_s,
                  "sweep_launches": sweep_launches}), flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_src", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    sides = [str(args.other_src.resolve()), str(ROOT / "src")]
    order = [sides[0], sides[1], sides[1], sides[0]] * args.rounds
    for src in order:
        run = subprocess.run([sys.executable, "-c", CHILD, src], cwd=ROOT,
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
        if run.returncode != 0 or not lines:
            print(f"chip_compare_off: the run of {src} failed "
                  f"({run.returncode}):\n{run.stderr[-3000:]}",
                  file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    import chip_smoke
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
