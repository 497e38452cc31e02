"""Pass ``tripwire`` — ``assert_compile_flat``, the dispatch-key tripwire.

The port compiles nothing per shape (its kernels are built once per
source), but every dispatch records its key — ``(static_key, registry,
batch?, donate?, shape signature)``, as the JAX package keys its compiled
entry points — in ``core/emulator._DISPATCH_KEYS``, and
``Engine.compile_count`` counts them. "No new dispatch key after warmup"
is the serving contract: a dispatch shape outside the warmed buckets
shows up as a new key. This module provides the context manager that
holds it:

    with assert_compile_flat(engine) as cc:
        ... steady-state work ...
    # raises RecompileError listing the new keys if any appeared;
    # cc.count / cc.new_entries for reporting

and the pass itself verifies (AST) that the adoption sites still use it
— a dropped tripwire is how such regressions return.

Fixture protocol: ``reprolint_case()`` returning
``{"kind": "tripwire", "run": callable}`` where ``run`` performs work
under ``assert_compile_flat`` that records a fresh key; the pass reports
the resulting ``RecompileError`` as a finding.
"""
from __future__ import annotations

import ast
import contextlib
import pathlib

from .common import Finding, rel

PASS = "tripwire"

# Files that must keep using assert_compile_flat (the flat-key contract
# holders).
ADOPTION_SITES = (
    "tests/test_torch_serve.py",
    "examples/serve_continuous_torch.py",
)


class RecompileError(AssertionError):
    """Raised when a dispatch key appeared under ``assert_compile_flat``."""


class _KeyDelta:
    def __init__(self):
        self.count = 0
        self.new_entries: list[tuple] = []


def _dispatch_keys(skey):
    from ..core import emulator

    # The private key set is read here on purpose (same package, and the
    # keys make the error actionable: they carry the shape signature
    # that forced the new dispatch).
    return {k for k in emulator._DISPATCH_KEYS
            if skey is None or k[0] == skey}


@contextlib.contextmanager
def assert_compile_flat(engine=None, *, allow: int = 0, msg: str = ""):
    """Assert no new dispatch key is recorded inside the block.

    ``engine`` scopes the check to that engine's static geometry (its
    ``static_key``); None watches every key. ``allow`` permits a known
    number of new keys. Yields a handle whose ``count``/``new_entries``
    are filled on exit."""
    skey = None if engine is None else engine.static_key
    before = _dispatch_keys(skey)
    delta = _KeyDelta()
    yield delta
    new = list(_dispatch_keys(skey) - before)
    delta.count = len(new)
    delta.new_entries = new
    if delta.count > allow:
        detail = "; ".join(
            f"batch={k[2]} donate={k[3]} shape_sig={k[4]}" for k in new)
        prefix = f"{msg}: " if msg else ""
        raise RecompileError(
            f"{prefix}{delta.count} new dispatch key(s) recorded under "
            f"assert_compile_flat (allow={allow}): {detail}")


def _uses_tripwire(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id == "assert_compile_flat":
            return True
        if (isinstance(node, ast.Attribute)
                and node.attr == "assert_compile_flat"):
            return True
    return False


def run_repo(root: pathlib.Path) -> list[Finding]:
    findings: list[Finding] = []
    for site in ADOPTION_SITES:
        path = root / site
        if not path.exists():
            findings.append(Finding(site, 1, PASS,
                                    "adoption site vanished — update "
                                    "analysis.tripwire.ADOPTION_SITES"))
            continue
        if not _uses_tripwire(ast.parse(path.read_text())):
            findings.append(Finding(
                site, 1, PASS,
                "no assert_compile_flat use — the flat-key contract lost "
                "its tripwire here"))
    return findings


def run_paths(paths) -> list[Finding]:
    from .common import fixture_case

    findings: list[Finding] = []
    for path in paths:
        path = pathlib.Path(path)
        case = fixture_case(path)
        if not case or case.get("kind") != "tripwire":
            continue
        try:
            case["run"]()
        except RecompileError as e:
            findings.append(Finding(rel(path), case.get("line", 1), PASS,
                                    str(e)))
    return findings
