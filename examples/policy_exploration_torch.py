"""Design-space exploration on the PyTorch port — what the paper built its
platform for: sweep placement policies, NVM technologies and policy
knobs, compare outcomes quickly, and persist the results for cross-run
comparison (``examples/policy_exploration.py`` on ``repro_torch``).

Both studies run through ``repro_torch.sweep``: on a card every grid is
ONE launch of the chunk-step kernel, one thread-block cluster a design
point.

    PYTHONPATH=src python examples/policy_exploration_torch.py \
        [--device cpu] [--out policy_heatmap.csv] [--requests 40000]
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch import Engine                        # noqa: E402
from repro_torch.core import paper_platform           # noqa: E402
from repro_torch.device import resolve_device         # noqa: E402
from repro_torch.sweep import SweepSpec               # noqa: E402
from repro_torch.trace import TraceSpec, generate     # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the emulator")
    ap.add_argument("--out", default="policy_heatmap.csv",
                    help="CSV path for the hot_threshold x decay_every "
                         "heatmap rows (repro_torch.sweep.load_rows reads "
                         "it back)")
    ap.add_argument("--requests", type=int, default=40_000)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    trace = generate(TraceSpec(n_requests=args.requests,
                               footprint_pages=100_000, write_frac=0.4,
                               pattern="zipfian", zipf_alpha=1.05),
                     device=device)
    base = paper_platform().with_(chunk=512, hot_threshold=4,
                                  write_weight=4, decay_every=32)
    # One session serves both studies: the grids share the geometry.
    engine = Engine(base, device=device)

    # --- study 1: policy x NVM technology (paper Fig 8-style comparison)
    res = engine.sweep(SweepSpec(
        base=base,
        technologies=("3dxpoint", "stt-ram"),
        policies=("static", "hotness", "write_bias", "stream"),
    ), trace)
    print("policy x technology (one compiled sweep):")
    print(res.table())
    print()

    # --- study 2: hotness-policy knob heatmap, persisted to CSV
    # Zipfian hot pages accumulate hotness fast (write_weight is policy-
    # scoped and only biases write_bias, so this hotness grid counts all
    # accesses equally), and the interesting threshold range spans orders
    # of magnitude: the top end effectively disables migration and
    # converges to the static baseline.
    thresholds = (2, 32, 512, 8192)
    decays = (8, 32, 128)
    res2 = engine.sweep(SweepSpec(
        base=base.with_(policy="hotness"),
        extra_axes=(("hot_threshold", thresholds),
                    ("decay_every", decays)),
    ), trace)
    rows = {(r["hot_threshold"], r["decay_every"]): r for r in res2.rows()}

    print("AMAT (cycles) heatmap — hot_threshold (rows) x decay_every (cols):")
    label_w = max(len(f"hot_threshold={th}") for th in thresholds)
    print(" " * label_w + "".join(f"{d:>10d}" for d in decays))
    for th in thresholds:
        cells = "".join(f"{rows[(th, d)]['amat_cyc']:10.1f}" for d in decays)
        print(f"hot_threshold={th}".ljust(label_w) + cells)

    path = res2.to_csv(args.out)
    print(f"\nheatmap rows written to {path} "
          "(load with repro_torch.sweep.load_rows for cross-run comparison)")


if __name__ == "__main__":
    main()
