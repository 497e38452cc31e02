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


def pragma_filter(findings: list[Finding], root: pathlib.Path
                  ) -> list[Finding]:
    """:func:`apply_pragmas` against each finding's own source file (a
    path relative to ``root``, or absolute); findings on no file pass."""
    by_path: dict = {}
    out = []
    for f in findings:
        p = root / f.path
        if not p.is_file():
            out.append(f)
            continue
        by_path.setdefault(p, []).append(f)
    for p, fs in by_path.items():
        out.extend(apply_pragmas(fs, p.read_text()))
    return out


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


# --------------------------------------------------------------------------- #
# The adversarial chunk-step probe the dynamic passes run
# --------------------------------------------------------------------------- #

def adversarial_step(cfg=None, registry=None, *, seed: int = 0,
                     n_chunks: int = 6, device="cpu") -> dict:
    """Inputs for ``kernels.chunk_step.step_batch`` that reach every
    branch the passes watch: one design point per policy of ``registry``
    (each its own ``policy_id``), a start state holding pins, a POISONED
    page and a swap in flight, a fault plan with deaths and transients,
    and ``n_chunks`` chunks of requests on pages 0 and ``n_pages - 1``,
    on the swap pair and on random pages, some lanes invalid with pages
    past either end of the table. Returns ``dict(cfg, registry, states,
    params, faults, chunks)``; ``chunks`` is a list of (page, offset,
    is_write, size, valid), each [B, chunk]."""
    import numpy as np
    import torch

    from ..core import faults as faults_lib
    from ..core import small_platform
    from ..core import table as table_lib
    from ..core.config import RuntimeParams
    from ..core.emulator import init_states
    from ..core.policies import PolicyRegistry

    cfg = cfg or small_platform(chunk=8, hot_threshold=2, decay_every=4,
                                endurance_budget=2, write_weight=3)
    registry = registry or PolicyRegistry.snapshot()
    b = len(registry)
    one = RuntimeParams.from_config(cfg, device=device)
    params = RuntimeParams(*(x.expand(b).clone() for x in one))._replace(
        policy_id=torch.arange(b, dtype=torch.int32, device=device))
    states = init_states(cfg, params)
    nf, n = cfg.n_fast_pages, cfg.n_pages
    table = table_lib.set_flags(states.table, [[0, 1]] * b,
                                table_lib.PIN_FAST)
    table = table_lib.set_flags(table, [[nf + 1]] * b, table_lib.PIN_SLOW)
    table = table_lib.set_flags(table, [[nf + 3]] * b, table_lib.POISONED)
    states.table.copy_(table)
    full = lambda v: torch.full((b,), v, dtype=torch.int32, device=device)
    states = states._replace(dma=states.dma._replace(
        active=full(1), page_a=full(nf + 2), page_b=full(nf - 1),
        start=full(0)))
    rng = np.random.default_rng(seed)
    m = n_chunks * cfg.chunk
    page = np.where(rng.random(m) < 0.5, nf + rng.integers(0, 6, m),
                    rng.integers(0, n, m))
    page[rng.random(m) < 0.2] = nf + 2                     # the swap pair
    page[::5], page[1::7] = 0, n - 1                       # both ends
    valid = rng.random(m) >= 0.15
    page[~valid] = rng.choice([-1, -n - 3, n, n + 7], (~valid).sum())
    offset = rng.integers(0, cfg.page_size // 64, m) * 64
    is_write = rng.random(m) < 0.5
    size = np.full(m, cfg.line_size)
    arrays = [torch.from_numpy(a.astype(dt)).to(device)
              for a, dt in ((page, np.int32), (offset, np.int32),
                            (is_write, bool), (size, np.int32),
                            (valid, bool))]
    chunks = [tuple(a[c * cfg.chunk:(c + 1) * cfg.chunk].expand(b, -1)
                    .contiguous() for a in arrays) for c in range(n_chunks)]
    faults = faults_lib.seeded_plan(seed, pages=np.arange(nf, n),
                                    n_chunks=n_chunks, n_deaths=2,
                                    n_transient=6, device=device)
    return dict(cfg=cfg, registry=registry, states=states, params=params,
                faults=faults, chunks=chunks)
