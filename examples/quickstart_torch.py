"""Quickstart on the PyTorch port: open an emulation session, run a
workload, read the counters, and sweep the NVM technology — all through
``repro_torch.Engine`` (``examples/quickstart.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py             # on a card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch import Engine                       # noqa: E402
from repro_torch.core import paper_platform          # noqa: E402
from repro_torch.device import resolve_device        # noqa: E402
from repro_torch.sweep import SweepSpec              # noqa: E402
from repro_torch.trace import workload_trace         # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the emulator")
    ap.add_argument("--requests", type=int, default=2048,
                    help="least number of requests of the trace")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # The paper's platform: 128MB DRAM + 1GB 3D-XPoint behind a PCIe link.
    cfg = paper_platform().with_(chunk=512, policy="hotness",
                                 hot_threshold=4)
    # One session: one geometry, many runs and sweeps. On a card a run is
    # one launch of the chunk-step kernel.
    engine = Engine(cfg, device=device)

    # One SPEC-2017-like workload from Table III (scaled for a short run).
    trace, workload, n = workload_trace("520.omnetpp", scale=1e-8,
                                        min_requests=args.requests,
                                        device=device)
    print(f"workload {workload.name}: {n} post-cache memory requests, "
          f"footprint {workload.footprint_bytes >> 20} MB")

    result = engine.run(trace)
    state = result.state
    print(f"emulated time: {int(state.clock)/1e6:.2f} ms "
          f"| migrations: {int(state.dma.swaps_done)}")
    for k, v in result.summary().items():
        print(f"  {k:24s} {v}")

    # Swap the NVM technology (paper §III-F: arbitrary stall cycles). All
    # three design points run in ONE sweep of the same session (one
    # kernel launch on a card).
    res = engine.sweep(SweepSpec(base=cfg, technologies=(
        "3dxpoint", "stt-ram", "flash")), trace)
    for row in res.rows():
        print(f"NVM={row['tech']:9s} mean read latency "
              f"{row['amat_cyc']:10.1f} cycles | migrations {row['swaps']}")


if __name__ == "__main__":
    main()
