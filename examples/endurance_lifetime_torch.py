"""Lifetime-vs-AMAT Pareto study on the PyTorch port: endurance budget x
policy x fault rate (``examples/endurance_lifetime.py`` on
``repro_torch``).

The retirement subsystem turns endurance into a *closed-loop* design
axis: a traced ``endurance_budget`` caps per-frame writes — frames that
cross it are poisoned and their pages rescued to healthy frames — and a
seeded :class:`~repro.core.faults.FaultPlan` injects early frame deaths
on top. This study sweeps

    endurance_budget x policy   (one ``Engine.sweep`` grid: one launch
                                 of the chunk-step kernel on a card)
    x fault rate                (stacked per-point ``FaultPlan`` batches)

and reads out the paper-facing trade-off: aggressive budgets flatten
peak wear (longer projected lifetime) but burn DMA bandwidth on rescue
migrations (higher AMAT); fault pressure shifts every point. All fault
rates reuse ONE dispatch signature — plans are padded to a common event
shape, so ``Engine.compile_count`` is flat after the first rate
(asserted by ``--check``).

    PYTHONPATH=src python examples/endurance_lifetime_torch.py \
        [--device cpu] [--quick] [--check] [--out endurance_lifetime.csv] \
        [--requests N]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np                                         # noqa: E402

from repro_torch import Engine                             # noqa: E402
from repro_torch.core import EmulatorConfig, check_table   # noqa: E402
from repro_torch.core import faults as faults_lib          # noqa: E402
from repro_torch.device import resolve_device              # noqa: E402
from repro_torch.sweep import SweepSpec                    # noqa: E402
from wear_leveling_torch import churn_trace, lifetime_days  # noqa: E402

BUDGETS = (0, 120, 400)             # 0 = retirement off
POLICIES = ("hotness", "wear_level")
FAULT_RATES = (0.0, 0.01, 0.03)     # fraction of slow frames dying early


def stacked_plans(base: EmulatorConfig, rate: float, n_points: int,
                  n_chunks: int, max_deaths: int,
                  device=None) -> faults_lib.FaultPlan:
    """One seeded plan per design point (distinct seeds — independent
    death draws), padded to a shared event shape so every fault rate
    reuses the compiled sweep entry."""
    n_deaths = int(round(rate * base.n_slow_pages))
    slow = np.arange(base.n_fast_pages, base.n_pages)
    plans = [
        faults_lib.pad_plan(
            faults_lib.seeded_plan(1000 + i, pages=slow, n_chunks=n_chunks,
                                   n_deaths=n_deaths,
                                   n_transient=8 * n_deaths, device=device),
            max(8 * max_deaths, 1), max(max_deaths, 1))
        for i in range(n_points)
    ]
    return faults_lib.stack_plans(plans)


def pareto(rows: list[dict]) -> set[int]:
    """Indices of rows not dominated on (AMAT min, lifetime max)."""
    front = set()
    for i, r in enumerate(rows):
        dominated = any(
            o["amat_cyc"] <= r["amat_cyc"]
            and o["lifetime_days"] >= r["lifetime_days"]
            and (o["amat_cyc"] < r["amat_cyc"]
                 or o["lifetime_days"] > r["lifetime_days"])
            for o in rows)
        if not dominated:
            front.add(i)
    return front


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the emulator")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized run (fewer requests)")
    ap.add_argument("--check", action="store_true",
                    help="assert compile flatness, table invariants, and "
                         "fault-pressure monotonicity")
    ap.add_argument("--out", default=None,
                    help="CSV path for all rows (+lifetime/fault columns)")
    ap.add_argument("--requests", type=int, default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = EmulatorConfig(n_fast_pages=64, n_slow_pages=448, chunk=256,
                          hot_threshold=4, decay_every=8, wear_slack=16)
    n = args.requests or (40_000 if args.quick else 120_000)
    trace = churn_trace(base, n, hot_w=96, period=2048, write_frac=0.7,
                        device=device)
    n_chunks = n // base.chunk

    spec = SweepSpec(base=base, policies=POLICIES,
                     extra_axes=(("endurance_budget", BUDGETS),))
    n_points = len(spec.build())
    max_deaths = int(round(max(FAULT_RATES) * base.n_slow_pages))

    engine = Engine(base, device=device)
    all_rows: list[dict] = []
    compiles = []
    for rate in FAULT_RATES:
        faults = stacked_plans(base, rate, n_points, n_chunks, max_deaths,
                               device=device)
        res = engine.sweep(spec, trace, faults=faults)
        compiles.append(engine.compile_count)
        rows = res.rows()
        clock = res.states.clock.cpu().numpy()
        for i, (r, c) in enumerate(zip(rows, clock)):
            r["fault_rate"] = rate
            r["lifetime_days"] = round(
                lifetime_days(base, r["nvm_peak_wear"], int(c)), 3)
            if args.check:
                check_table(res.points[i].cfg,
                            res.states.table[i].cpu().numpy())
        all_rows.extend(rows)

    front = pareto(all_rows)
    keys = ("policy", "endurance_budget", "fault_rate", "amat_cyc",
            "fast_hit_rate", "nvm_peak_wear", "frames_retired",
            "transient_faults", "lifetime_days")

    def fmt(r, k):
        v = r[k]
        return f"{v:.3f}" if isinstance(v, float) else str(v)

    widths = [max(len(k), *(len(fmt(r, k)) for r in all_rows)) for k in keys]
    print(f"endurance budget x policy x fault rate ({len(all_rows)} design "
          "points, one compiled sweep reused across fault rates):")
    print("  ".join(k.ljust(w) for k, w in zip(keys, widths)) + "  pareto")
    for i, r in enumerate(all_rows):
        mark = "  *" if i in front else ""
        print("  ".join(fmt(r, k).rjust(w)
                        for k, w in zip(keys, widths)) + mark)

    if args.out:
        import csv
        with open(args.out, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(all_rows[0]) + ["pareto"])
            w.writeheader()
            for i, r in enumerate(all_rows):
                w.writerow({**r, "pareto": int(i in front)})
        print(f"rows written to {args.out}")

    if args.check:
        assert len(set(compiles)) == 1, \
            f"fault-rate sweeps recompiled: compile counts {compiles}"
        by = {(r["policy"], r["endurance_budget"], r["fault_rate"]): r
              for r in all_rows}
        for pol in POLICIES:
            # budget=0, rate=0 is the frozen baseline: nothing retires
            clean = by[(pol, 0, 0.0)]
            assert clean["frames_retired"] == 0
            assert clean["transient_faults"] == 0
            # a finite budget under this churn retires frames
            assert by[(pol, BUDGETS[1], 0.0)]["frames_retired"] > 0, \
                f"budget={BUDGETS[1]} never fired for {pol}"
            # fault pressure is monotone in the injected death count
            r0 = by[(pol, 0, FAULT_RATES[1])]["frames_retired"]
            r1 = by[(pol, 0, FAULT_RATES[2])]["frames_retired"]
            assert 0 < r0 <= r1, f"deaths not monotone for {pol}: {r0},{r1}"
        assert front, "empty Pareto front"
        print("--check passed: one compilation across fault rates, "
              "tables valid, retirement fires and scales with fault rate")


if __name__ == "__main__":
    main()
