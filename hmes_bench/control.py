"""The control of the comparison that decides ``correct``, and the
program's readings beside it, for one cell on several seeds:

    python3 hmes_bench/control.py --workload <cell> --seeds 1 2 3

For each seed: the cell's first trace (the seed's own draw, as a run
makes it), ONE answer of the program, and ONE run of the plain
reference, whose counters are folded twice: in float32 (the reference)
and in bfloat16 (the control, the reference put in the program's place
one precision below the configuration's float32 counters). Prints one
JSON line a seed: the numbers of :mod:`judge` for the program and for
the control against the reference. The control has to fail one of them;
the benchmark's own runs do not run it.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(root: pathlib.Path, workload: str, seed: int, device) -> dict:
    """{"program": numbers, "control": numbers, ...} for one seed."""
    import torch

    from hmes_bench import harness, judge, program, reference
    _, config, traffic, session = harness.load_cell(root, workload, device)
    trace = harness.make_traces(config, traffic, seed, count=1)[0]
    n = config["requests"]
    res, readout = session.answer(program.trace_on(trace, device))
    got = session.record(res, readout, n)
    del res
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want, low = reference.answer(config, session.grid, trace, device,
                                 control=True)
    return {"workload": workload, "seed": seed,
            "program": judge.compare(got, want),
            "control": judge.compare(low, want),
            "reference_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    here = str(pathlib.Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p not in (here, "")]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("hmes_bench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(ROOT, args.workload, seed,
                                  torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
