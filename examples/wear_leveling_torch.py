"""Endurance study on the PyTorch port — the paper's core asymmetry
(Table I) as a design space: NVM absorbs a limited number of writes per
cell, so placement policies are judged not only on AMAT/hit-rate but on
how evenly they spread writes over slow frames (the packed table's WEAR
lane, charged by demand writes AND by the DMA engine's full-page
migration writes). ``examples/wear_leveling.py`` on ``repro_torch``.

The study sweeps pin fraction x policy x write_weight as ONE sweep (one
launch of the chunk-step kernel on a card) over a churn-heavy write trace
(rotating hot window wider than the fast tier, so migration never
settles), then derives a device-lifetime estimate from each point's peak
frame wear:

    lifetime ~ endurance_per_cell / (peak_wear / emulated_time)

``wear_level`` must beat plain ``hotness`` on peak wear at (near-)equal
hit rate — asserted by ``--check``.

    PYTHONPATH=src python examples/wear_leveling_torch.py \
        [--device cpu] [--quick] [--check] [--out wear_leveling.csv] \
        [--requests N]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np                                     # noqa: E402
import torch                                           # noqa: E402

from repro_torch import Engine                         # noqa: E402
from repro_torch.core import EmulatorConfig, Trace     # noqa: E402
from repro_torch.core import table as table_lib        # noqa: E402
from repro_torch.device import resolve_device          # noqa: E402
from repro_torch.sweep import SweepSpec                # noqa: E402


def churn_trace(cfg: EmulatorConfig, n: int, hot_w: int, period: int,
                write_frac: float, seed: int = 0, device=None) -> Trace:
    """Rotating write-hot window over the slow tier, wider than the fast
    tier: promotions churn continuously, so both demand writes and
    migration writes keep landing on NVM frames. Drawn with numpy from
    ``seed`` (the same draws as ``examples/wear_leveling.py``), then moved
    to ``device``."""
    rng = np.random.default_rng(seed)
    nf, ns = cfg.n_fast_pages, cfg.n_slow_pages
    idx = np.arange(n)
    base = (idx // period) * (hot_w // 2)   # rotate by half a window
    page = (nf + (base + rng.integers(0, hot_w, n)) % ns).astype(np.int32)
    off = (rng.integers(0, cfg.page_size // 64, n) * 64).astype(np.int32)
    wr = rng.random(n) < write_frac
    sz = np.full(n, 64, np.int32)
    return Trace(*(torch.as_tensor(x, device=device)
                   for x in (page, off, wr, sz)))


def lifetime_days(cfg: EmulatorConfig, peak_wear: int,
                  emulated_cycles: int) -> float:
    """Crude lifetime projection: cycles are ns, each WEAR unit is one
    line-sized write to the most-worn frame, endurance is per-cell write
    cycles (config technology table)."""
    if peak_wear <= 0:
        return float("inf")
    endurance = 10.0 ** cfg.slow.endurance_log10
    writes_per_s = peak_wear / (emulated_cycles * 1e-9)
    return endurance / writes_per_s / (24 * 3600)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the emulator")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized run (fewer requests)")
    ap.add_argument("--check", action="store_true",
                    help="assert wear_level beats hotness on peak wear "
                         "at (near-)equal hit rate")
    ap.add_argument("--out", default=None,
                    help="CSV path for the sweep rows (+lifetime column)")
    ap.add_argument("--requests", type=int, default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = EmulatorConfig(n_fast_pages=64, n_slow_pages=448, chunk=256,
                          hot_threshold=4, decay_every=8, wear_slack=16)
    n = args.requests or (40_000 if args.quick else 120_000)
    trace = churn_trace(base, n, hot_w=96, period=2048, write_frac=0.7,
                        device=device)

    # pin fraction x policy x write_weight: one sweep.
    res = Engine(base, device=device).sweep(SweepSpec(
        base=base,
        policies=("static", "hotness", "write_bias", "wear_level"),
        extra_axes=(("pin_fast_fraction", (0.0, 0.25)),
                    ("write_weight", (1, 4))),
    ), trace)

    rows = res.rows()
    clock = res.states.clock.cpu().numpy()
    for r, c in zip(rows, clock):
        r["lifetime_days"] = round(lifetime_days(base, r["nvm_peak_wear"],
                                                 int(c)), 3)

    keys = ("label", "amat_cyc", "fast_hit_rate", "swaps", "nvm_peak_wear",
            "nvm_total_writes", "lifetime_days")
    widths = [max(len(k), *(len(f"{r[k]:.3f}" if isinstance(r[k], float)
                                else str(r[k])) for r in rows)) for k in keys]
    print("endurance study — pin fraction x policy x write_weight "
          f"({len(rows)} design points, one compilation):")
    print("  ".join(k.ljust(w) for k, w in zip(keys, widths)))
    for r in rows:
        cells = [f"{r[k]:.3f}" if isinstance(r[k], float) else str(r[k])
                 for k in keys]
        print("  ".join(v.rjust(w) for v, w in zip(cells, widths)))

    def row(policy, pin=0.0, ww=1):
        return next(r for r in rows if r["policy"] == policy
                    and r["pin_fast_fraction"] == pin
                    and r["write_weight"] == ww)

    hot, wl = row("hotness"), row("wear_level")
    print(f"\nwear_level vs hotness (pin=0, write_weight=1): peak wear "
          f"{wl['nvm_peak_wear']} vs {hot['nvm_peak_wear']}, hit rate "
          f"{wl['fast_hit_rate']:.3f} vs {hot['fast_hit_rate']:.3f}, "
          f"lifetime {wl['lifetime_days']}d vs {hot['lifetime_days']}d")

    if args.out:
        import csv
        with open(args.out, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"rows written to {args.out}")

    # pinning sanity: every pinned point kept its pinned pages in DRAM
    dev = table_lib.device(res.states.table).cpu().numpy()
    flg = table_lib.flags(res.states.table).cpu().numpy()
    for i, r in enumerate(rows):
        pinned = (flg[i] & table_lib.PIN_FAST) != 0
        assert (dev[i][pinned] == 0).all(), f"pinned page migrated at {i}"

    if args.check:
        assert wl["nvm_peak_wear"] < hot["nvm_peak_wear"], \
            f"wear_level peak {wl['nvm_peak_wear']} !< hotness " \
            f"{hot['nvm_peak_wear']}"
        assert wl["fast_hit_rate"] >= hot["fast_hit_rate"] - 0.02, \
            f"wear_level hit {wl['fast_hit_rate']} << {hot['fast_hit_rate']}"
        assert wl["lifetime_days"] > hot["lifetime_days"]
        print("--check passed: wear_level flattens peak NVM wear at "
              "(near-)equal hit rate")


if __name__ == "__main__":
    main()
