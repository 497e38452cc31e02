"""CLI: ``python -m repro_torch.analysis [--check] [--pass NAME] [paths...]``.

Repo mode (no paths) runs the selected passes — all eight by default —
against the port's tree and exits 1 when any finding survives the
pragmas. File/fixture mode (explicit paths) runs the selected passes
against those files only: AST passes lint them, the dynamic passes
execute their ``reprolint_case()`` if present.

``--report FILE`` writes a JSON report::

    {"findings": [{path, line, pass_name, message}, ...],
     "proved_bounds": [...],   # the ranges pass's budget, G, horizon and
                               # its budget run's end values
     "stats": {"<pass>": seconds, ..., "total": seconds}}

and prints the bounds. ``--baseline FILE`` loads a previous report and
exits 1 only on findings NOT present in it (keyed on (path, pass_name,
message) — line numbers drift with unrelated edits); the file is read,
never written. ``--stats`` prints per-pass wall time.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import PASSES, run_pass


def _load_baseline(path) -> set:
    """Known-finding keys from a previous ``--report`` JSON (either the
    ``{"findings": [...]}`` shape or a flat list)."""
    with open(path) as fh:
        data = json.load(fh)
    rows = data["findings"] if isinstance(data, dict) else data
    return {(r["path"], r["pass_name"], r["message"]) for r in rows}


def _print_bounds(bounds: list) -> None:
    for b in bounds:
        if b.get("label") == "budget_run":
            ends = ", ".join(f"{k} {v}" for k, v in b["ends"].items())
            verdict = b["problems"] or "saturated, nothing wrapped"
            print(f"reprolint: ranges budget run, {b['n_chunks']} chunks "
                  f"of {b['chunk']} from time {b['time0']}: {verdict}; "
                  f"ends {ends}")
        else:
            print(f"reprolint: ranges {b['label']}: budget "
                  f"{b['n_chunks_budget']} chunks, per-chunk growth G "
                  f"{b['per_chunk_growth']}, int32 horizon "
                  f"{b['int32_horizon_chunks']} chunks; table indices "
                  f"checked {b['table_indices_checked']}")


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
                    help="also write findings + the ranges' bounds as JSON")
    ap.add_argument("--baseline", metavar="FILE",
                    help="previous --report JSON; exit 1 only on "
                         "findings not already present in it")
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

    new = findings
    if args.baseline:
        known = _load_baseline(args.baseline)
        new = [f for f in findings
               if (f.path, f.pass_name, f.message) not in known]

    for f in findings:
        print(f.format() + ("" if f in new else " (baseline)"))
    if args.stats:
        for name in names:
            print(f"reprolint: pass {name} took {stats[name]:.3f}s")
        print(f"reprolint: total analyzer time {stats['total']:.3f}s")
    if args.report:
        from . import ranges
        if "ranges" in names and not args.paths:
            ranges.report_bounds()
        _print_bounds(ranges.LAST_BOUNDS)
        with open(args.report, "w") as fh:
            json.dump({"findings": [f.as_dict() for f in findings],
                       "proved_bounds": list(ranges.LAST_BOUNDS),
                       "stats": stats}, fh, indent=2, default=str)
    scope = "repo" if not args.paths else f"{len(args.paths)} file(s)"
    tail = f", {len(new)} new vs baseline" if args.baseline else ""
    print(f"reprolint: {len(findings)} finding(s){tail} "
          f"[{', '.join(names)}] on {scope}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
