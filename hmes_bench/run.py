"""Run one benchmark cell once and print its result as the last line of
standard output:

    python3 hmes_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

(or ``python3 -m hmes_bench.run ...``) from the root of the checkout.
It needs as many CUDA cards as the cell asks for and has no CPU mode:
without them it exits with code 2 and prints no result. It exits with
code 3, and prints no result, where the run has loaded JAX or the JAX
package.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _paths() -> None:
    """The checkout's root (this package) and ``src`` (the program) on
    the import path, the script's own directory off it."""
    here = str(pathlib.Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p not in (here, "")]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from hmes_bench import discover, harness
    chips = discover.cell(discover.load_benchmark(ROOT),
                          args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hmes_bench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"hmes_bench: the run loaded {found}: the benchmark measures "
              "the PyTorch port alone", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
