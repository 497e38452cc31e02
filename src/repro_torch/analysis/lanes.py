"""Pass ``lanes`` — lane-accessor discipline on the packed table.

``core/table.py`` is the single source of truth for the packed
``int32[..., n_pages, ROW_W]`` redirection-table layout. Raw lane
indexing — ``table[..., HOTNESS]``, ``rows[:, 2]`` — anywhere else
couples callers to the physical layout. The contract:

  * the lane index constants (``DEVICE``/``FRAME``/``HOTNESS``/``WEAR``/
    ``OWNER``/``EPOCH``/``FLAGS``/``_PAD``) may be *referenced* only
    inside the allowlist (``core/table.py`` itself, and
    ``kernels/chunk_step.py``, whose plain step and kernel packing work
    on the lanes);
  * subscripting a table-like value with a bare integer lane is banned
    everywhere outside the allowlist;
  * everyone else goes through the accessors (``device``, ``hotness``,
    ``flags``, ``set_flags``, ...), or names the lane to the lane
    accessors of ``core/indexing.py`` (``take_lane(table, idx,
    table_lib.FLAGS)``, ``put_lane_``), which is where a lane constant
    may appear as an argument.

FLAGS *bit* constants (``PIN_FAST``, ``POISONED``, ...) are public
vocabulary and stay legal everywhere. The table module is recognised
under its absolute name (``repro_torch.core.table``) and under the
relative imports the package uses (``from ..core import table``,
``from . import table``, ``from .table import FLAGS``).

Purely an AST pass — fixture files are linted directly by path.
"""
from __future__ import annotations

import ast
import pathlib

from .common import Finding, apply_pragmas, iter_py_files, rel

PASS = "lanes"

LANE_NAMES = {"DEVICE", "FRAME", "HOTNESS", "WEAR", "OWNER", "EPOCH",
              "FLAGS", "_PAD"}

# Files where raw lane indexing is the point.
ALLOWLIST = {
    "src/repro_torch/core/table.py",
    "src/repro_torch/kernels/chunk_step.py",
}

# core/indexing.py's accessors, which take the lane by name.
LANE_ACCESSORS = {"take_lane", "put_lane_"}

_ROW_W = 8


def _is_core(module: str | None, level: int) -> bool:
    """Does ``from <level dots><module> import ...`` name the core
    package (absolute, or relative from a sibling package or from inside
    it)?"""
    if level == 0:
        return module == "repro_torch.core"
    return module == "core" or (module is None and level == 1)


def _is_table(module: str | None, level: int) -> bool:
    if level == 0:
        return module == "repro_torch.core.table"
    return module in ("core.table", "table")


def _table_aliases(tree: ast.AST) -> tuple[set[str], set[str]]:
    """(module aliases of the table module, directly imported lane
    constant names) in this file."""
    mod_aliases: set[str] = set()
    lane_names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "repro_torch.core.table":
                    mod_aliases.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom):
            if _is_core(node.module, node.level):
                for a in node.names:
                    if a.name == "table":
                        mod_aliases.add(a.asname or "table")
            elif _is_table(node.module, node.level):
                for a in node.names:
                    if a.name in LANE_NAMES:
                        lane_names.add(a.asname or a.name)
    return mod_aliases, lane_names


def _mentions_table(node: ast.AST) -> bool:
    """Heuristic: does this expression look like the packed table?"""
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and "table" in n.id.lower():
            return True
        if isinstance(n, ast.Attribute) and "table" in n.attr.lower():
            return True
    return False


def _accessor_lane_args(tree: ast.AST) -> set[int]:
    """ids of the nodes passed as arguments to a lane accessor."""
    out: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if name in LANE_ACCESSORS:
                out.update(id(a) for a in node.args)
                out.update(id(k.value) for k in node.keywords)
    return out


def check_source(source: str, path: str) -> list[Finding]:
    tree = ast.parse(source)
    mod_aliases, lane_names = _table_aliases(tree)
    named = _accessor_lane_args(tree)
    findings: list[Finding] = []
    for node in ast.walk(tree):
        if id(node) in named:
            continue
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, (ast.Name, ast.Attribute))
                and ast.unparse(node.value) in mod_aliases
                and node.attr in LANE_NAMES):
            findings.append(Finding(
                path, node.lineno, PASS,
                f"raw lane constant `{ast.unparse(node)}` outside "
                "core/table.py — use the lane accessors "
                "(device/hotness/flags/set_flags/...)"))
        elif (isinstance(node, ast.Name)
              and isinstance(node.ctx, ast.Load)
              and node.id in lane_names):
            findings.append(Finding(
                path, node.lineno, PASS,
                f"lane constant `{node.id}` imported and used outside "
                "core/table.py — use the lane accessors"))
        elif isinstance(node, ast.Subscript) and _mentions_table(node.value):
            sl = node.slice
            elems = sl.elts if isinstance(sl, ast.Tuple) else [sl]
            last = elems[-1]
            if (len(elems) >= 2 and isinstance(last, ast.Constant)
                    and isinstance(last.value, int)
                    and 0 <= last.value < _ROW_W):
                findings.append(Finding(
                    path, node.lineno, PASS,
                    f"bare integer lane index `[..., {last.value}]` on a "
                    "table-like value — use the lane accessors"))
    return apply_pragmas(findings, source)


def check_file(path: pathlib.Path) -> list[Finding]:
    return check_source(path.read_text(), rel(path))


def run_repo(root: pathlib.Path) -> list[Finding]:
    findings: list[Finding] = []
    for path in iter_py_files(root):
        if rel(path, root) in ALLOWLIST:
            continue
        findings += check_file(path)
    return findings


def run_paths(paths) -> list[Finding]:
    findings: list[Finding] = []
    for path in paths:
        findings += check_file(pathlib.Path(path))
    return findings
