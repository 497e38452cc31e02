"""Pass ``docrefs`` — no stale references to deleted entry points.

The JAX package deleted its legacy free functions (``emulate``,
``run_sweep``, ``run_trace``, ``emulate_channels``) and
``sweep/runner.py`` in favour of the ``Engine`` session API; the port
never had them. Dead identifiers cannot break tests, so only a
text-level check keeps the port's docstrings and comments from pointing
readers at them: any mention of a legacy token in a ``.py`` file under
the scanned roots (the port's package, its examples, the card scripts
and its tests) is a finding.

The analysis package itself is excluded — this file names the banned
tokens as data.
"""
from __future__ import annotations

import pathlib
import re

from .common import (DEFAULT_SCAN_GLOBS, Finding, apply_pragmas,
                     iter_py_files, rel)

PASS = "docrefs"

TOKENS: tuple[tuple[re.Pattern, str], ...] = (
    (re.compile(r"``emulate``"), "``emulate`` doc reference"),
    (re.compile(r"(?<![\w`])emulate\("), "legacy `emulate(` call form"),
    (re.compile(r"\brun_sweep\b"), "legacy `run_sweep`"),
    (re.compile(r"\brun_trace\b"), "legacy `run_trace`"),
    (re.compile(r"\bemulate_channels\b"), "legacy `emulate_channels`"),
    (re.compile(r"\bsweep[./]runner\b"), "deleted `sweep/runner.py`"),
)

SCAN_GLOBS = DEFAULT_SCAN_GLOBS + ("tests/test_torch_*.py",)


def check_source(source: str, path: str) -> list[Finding]:
    findings: list[Finding] = []
    for i, text in enumerate(source.splitlines(), start=1):
        for pat, what in TOKENS:
            if pat.search(text):
                findings.append(Finding(
                    path, i, PASS,
                    f"{what} — the legacy entry points were deleted in "
                    "favour of the Engine session (repro_torch.Engine)"))
    return apply_pragmas(findings, source)


def check_file(path: pathlib.Path) -> list[Finding]:
    return check_source(path.read_text(), rel(path))


def run_repo(root: pathlib.Path) -> list[Finding]:
    findings: list[Finding] = []
    for path in iter_py_files(root, SCAN_GLOBS):
        findings += check_file(path)
    return findings


def run_paths(paths) -> list[Finding]:
    findings: list[Finding] = []
    for path in paths:
        findings += check_file(pathlib.Path(path))
    return findings
