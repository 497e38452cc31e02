"""CLI: ``python -m repro_torch.analysis [--check] [--pass NAME] [paths...]``.

Repo mode (no paths) runs the selected passes — all four by default —
against the port's tree and exits 1 when any finding survives the
pragmas. File/fixture mode (explicit paths) runs the selected passes
against those files only: AST passes lint them, the tripwire executes
their ``reprolint_case()`` if present.

``--report FILE`` writes a JSON report::

    {"findings": [{path, line, pass_name, message}, ...],
     "stats": {"<pass>": seconds, ..., "total": seconds}}

``--stats`` prints per-pass wall time.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import PASSES, run_pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint for the PyTorch port")
    ap.add_argument("paths", nargs="*",
                    help="files to check (fixture/file mode); none = "
                         "the port's tree")
    ap.add_argument("--check", action="store_true",
                    help="CI mode: run everything, exit 1 on findings "
                         "(the default behavior, spelled explicitly)")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=sorted(PASSES), metavar="NAME",
                    help="run only this pass (repeatable); default all")
    ap.add_argument("--report", metavar="FILE",
                    help="also write the findings as JSON")
    ap.add_argument("--stats", action="store_true",
                    help="print per-pass analyzer wall time")
    ap.add_argument("--list-passes", action="store_true")
    args = ap.parse_args(argv)

    if args.list_passes:
        for name, mod in PASSES.items():
            doc = (mod.__doc__ or "").strip().splitlines()[0]
            print(f"{name:12s} {doc}")
        return 0

    names = args.passes or list(PASSES)
    findings = []
    stats: dict[str, float] = {}
    for name in names:
        t0 = time.perf_counter()
        findings += run_pass(name, paths=args.paths or None)
        stats[name] = round(time.perf_counter() - t0, 3)
    stats["total"] = round(sum(stats.values()), 3)

    for f in findings:
        print(f.format())
    if args.stats:
        for name in names:
            print(f"reprolint: pass {name} took {stats[name]:.3f}s")
        print(f"reprolint: total analyzer time {stats['total']:.3f}s")
    if args.report:
        with open(args.report, "w") as fh:
            json.dump({"findings": [f.as_dict() for f in findings],
                       "stats": stats}, fh, indent=2, default=str)
    scope = "repo" if not args.paths else f"{len(args.paths)} file(s)"
    print(f"reprolint: {len(findings)} finding(s) [{', '.join(names)}] on "
          f"{scope}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
