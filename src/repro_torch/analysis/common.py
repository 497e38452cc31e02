"""Shared plumbing for the port's reprolint passes (the AST helpers of
``repro.analysis.common``; the jaxpr helpers have no counterpart here).

A *finding* is one contract violation at a file:line. Passes return
``list[Finding]``; the CLI renders them ``path:line: [pass] message`` and
exits non-zero when any survive. A finding on a line carrying a

    # reprolint: allow[<pass>] <reason>

pragma is suppressed — the pragma must name the pass (comma-separate to
allow several) and should state *why* the exemption is sound, because the
lint exists precisely where reviewer memory failed before.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import pathlib
import re

# Globs (relative to the repo root) that the AST passes sweep by default:
# the port's package, its examples and the card scripts. Tests are
# excluded: they deliberately poke at internals (and the seeded-violation
# fixtures MUST keep violating). The analysis package itself is excluded
# from the scans — it names the banned tokens as data.
DEFAULT_SCAN_GLOBS = ("src/repro_torch/**/*.py", "examples/*_torch.py",
                      "chip_*.py")

_PRAGMA_RE = re.compile(r"#\s*reprolint:\s*allow\[([a-z0-9_,\s-]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation at ``path:line``."""

    path: str
    line: int
    pass_name: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_name}] {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def repo_root() -> pathlib.Path:
    """The repository root (parent of ``src/repro_torch``), resolved from
    this file so the CLI works from any cwd."""
    root = pathlib.Path(__file__).resolve().parents[3]
    if not (root / "src" / "repro_torch").is_dir():  # installed copy
        root = pathlib.Path.cwd()
    return root


def rel(path: pathlib.Path | str, root: pathlib.Path | None = None) -> str:
    """Repo-relative display path (absolute when outside the repo)."""
    p = pathlib.Path(path).resolve()
    root = root or repo_root()
    try:
        return str(p.relative_to(root))
    except ValueError:
        return str(p)


def iter_py_files(root: pathlib.Path,
                  globs=DEFAULT_SCAN_GLOBS) -> list[pathlib.Path]:
    """The ``.py`` files under ``root`` that ``globs`` match, sorted,
    each once, the analysis package left out."""
    out: set[pathlib.Path] = set()
    for pattern in globs:
        out.update(p for p in root.glob(pattern)
                   if "__pycache__" not in p.parts
                   and "analysis" not in p.relative_to(root).parts)
    return sorted(out)


def pragma_lines(source: str) -> dict[int, set[str]]:
    """Map of 1-based line number -> pass names allowed on that line.

    An inline pragma covers its own line; a pragma on a comment-only
    line covers the next code line (comment/blank lines in between are
    skipped, so a pragma can open a multi-line explanation)."""
    out: dict[int, set[str]] = {}
    pending: set[str] = set()
    for i, text in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(text)
        stripped = text.strip()
        if m:
            passes = {p.strip() for p in m.group(1).split(",") if p.strip()}
            if stripped.startswith("#"):
                pending |= passes
            else:
                out.setdefault(i, set()).update(passes)
        if stripped.startswith("#") or not stripped:
            continue
        if pending:
            out.setdefault(i, set()).update(pending)
            pending = set()
    return out


def apply_pragmas(findings: list[Finding], source: str) -> list[Finding]:
    """Drop findings whose line carries an allow-pragma for their pass."""
    allowed = pragma_lines(source)
    return [f for f in findings
            if f.pass_name not in allowed.get(f.line, ())]


def load_module_from_path(path: pathlib.Path):
    """Import a fixture module by file path (no package side effects)."""
    path = pathlib.Path(path)
    spec = importlib.util.spec_from_file_location(
        f"_reprolint_fixture_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fixture_case(path: pathlib.Path):
    """The ``reprolint_case()`` dict of a fixture module, or None."""
    mod = load_module_from_path(path)
    case = getattr(mod, "reprolint_case", None)
    return case() if case is not None else None
