"""reprolint for the port — the passes whose contracts survive the change
of framework from JAX to PyTorch:

    PYTHONPATH=src python -m repro_torch.analysis --check

runs them against the port's tree (``src/repro_torch``,
``examples/*_torch.py`` and the ``chip_*.py`` card scripts) and exits
non-zero with ``path:line: [pass] message`` findings. Single passes run
with ``--pass <name>``; fixture/file mode takes explicit paths. To exempt
a line, add ``# reprolint: allow[<pass>] <why>`` — the reason is part of
the contract.

Passes: schedule (the chunk's table reads, its one boundary commit and
the writes after it, recorded op by op under a dispatch mode), donation
(a consumed state's result in the passed state's memory, the registry
of in-place sites, AST read-after-donate), lanes (AST lane-accessor
discipline on the packed table), staticness (AST: no per-point
``RuntimeParams`` tensor in Python control flow; ``static_key``
completeness by perturbation; the dispatch key is the geometry),
tripwire (``assert_compile_flat`` over the dispatch keys behind
``Engine.compile_count``, and its adoption sites), docrefs (stale
legacy-entry-point references), ranges (the declared run budget, the
int32 clock horizon, every table index in bounds; ``--report`` adds the
budget run's saturation), kernel_san (the CUDA kernels' shared-memory
footprints at every launch geometry; on the card, ``chip_smoke.py``
phase 18). The JAX package's ``schedule``, ``donation`` and ``ranges``
read jaxprs and ``pallas_san`` Pallas geometry: each module here says
how it restates its counterpart's contract for PyTorch.

This package imports no module of the JAX package.
"""
from __future__ import annotations

import pathlib

from . import (
    docrefs,
    donation,
    kernel_san,
    lanes,
    ranges,
    schedule,
    staticness,
    tripwire,
)
from .common import Finding, repo_root
from .tripwire import RecompileError, assert_compile_flat

__all__ = [
    "Finding",
    "PASSES",
    "RecompileError",
    "assert_compile_flat",
    "repo_root",
    "run_pass",
    "run_repo",
]

PASSES = {
    "schedule": schedule,
    "donation": donation,
    "lanes": lanes,
    "staticness": staticness,
    "tripwire": tripwire,
    "docrefs": docrefs,
    "ranges": ranges,
    "kernel_san": kernel_san,
}


def run_pass(name: str, paths=None, root=None) -> list[Finding]:
    """One pass, repo mode (``paths`` None) or file/fixture mode."""
    mod = PASSES[name]
    if paths:
        return mod.run_paths([pathlib.Path(p) for p in paths])
    return mod.run_repo(pathlib.Path(root) if root else repo_root())


def run_repo(passes=None, root=None) -> list[Finding]:
    """All (or the named) passes against the repo."""
    findings: list[Finding] = []
    for name in passes or PASSES:
        findings += run_pass(name, root=root)
    return findings
