"""Pass ``staticness`` — the split between what shapes a dispatch and what
travels per design point.

Everything in ``RuntimeParams`` is a tensor, one value a design point
(``[B]`` on a sweep's point axis); everything in ``static_key`` fixes the
dispatch (shapes, program structure, the key ``Engine.compile_count``
counts). The JAX package's traced/static contracts restated for the
port:

  * **no per-point ``RuntimeParams`` tensor in Python control flow**
    (AST): a ``RuntimeParams`` field reaching ``if``/``while``/
    ``assert`` or a ternary test forces a host synchronisation on a card
    and, on a point axis, branches every point on one point's value (or
    raises for more than one) — use ``torch.where`` on the tensor;
  * **static_key completeness** (runtime, perturbation-based): perturb
    every ``EmulatorConfig`` field (descending into the two
    ``TechnologyParams``); each perturbation must change ``static_key``
    or a ``RuntimeParams.from_config`` leaf, or the knob silently misses
    both the dispatch key and the computation;
  * **the dispatch key is the geometry, not the design point** (runtime;
    the JAX package's ``canonical_config`` check — the port has no
    canonical config, its sessions key dispatches on ``static_key``
    itself): a static field's perturbation gives an ``Engine`` a new
    ``static_key``, and a runtime-only field's leaves it equal, so one
    session serves every design point without new keys.

Plus a dtype cross-check: ``core.config.FLOAT_PARAM_FIELDS`` must agree
exactly with the float32 leaves of ``RuntimeParams.from_config`` (the
chunk-step kernel's int and float scalar packing splits on it).

Fixture protocol: AST violations are linted directly by path.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib

from .common import Finding, apply_pragmas, iter_py_files, rel

PASS = "staticness"

# Unannotated names conventionally bound to RuntimeParams in this package.
PARAM_NAME_HINTS = {"params", "p", "rp"}

# TechnologyParams subfields that are *documentation only* (`name` labels
# the row, and endurance_log10 is a datasheet number surfaced in reports,
# never read by the pipeline). Everything else must reach static_key or
# RuntimeParams.
INERT_SUBFIELDS = {"fast.name", "slow.name",
                   "fast.endurance_log10", "slow.endurance_log10"}

CONFIG_PATH = "src/repro_torch/core/config.py"


def _runtime_fields() -> frozenset[str]:
    from ..core.config import RuntimeParams

    return frozenset(RuntimeParams._fields)


# --- AST: control flow on per-point params --------------------------------


def _annotated_param_names(fn) -> set[str]:
    names = set()
    args = list(fn.args.posonlyargs) + list(fn.args.args) + \
        list(fn.args.kwonlyargs)
    for a in args:
        ann = a.annotation
        if ann is None:
            continue
        if "RuntimeParams" in ast.unparse(ann):
            names.add(a.arg)
    return names


def check_source(source: str, path: str) -> list[Finding]:
    tree = ast.parse(source)
    fields = _runtime_fields()
    findings: list[Finding] = []

    def flag_tests(fn, names):
        tests = []
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                tests.append(node.test)
        for test in tests:
            for n in ast.walk(test):
                if (isinstance(n, ast.Attribute)
                        and isinstance(n.value, ast.Name)
                        and n.value.id in names and n.attr in fields):
                    findings.append(Finding(
                        path, n.lineno, PASS,
                        f"per-point RuntimeParams tensor `{n.value.id}."
                        f"{n.attr}` reaches Python control flow — use "
                        "torch.where on the tensor"))

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            flag_tests(node, _annotated_param_names(node) | PARAM_NAME_HINTS)
    return apply_pragmas(findings, source)


def check_file(path: pathlib.Path) -> list[Finding]:
    return check_source(path.read_text(), rel(path))


# --- runtime: static_key completeness -------------------------------------


def _field_linenos(config_path: pathlib.Path) -> dict[str, int]:
    tree = ast.parse(config_path.read_text())
    out: dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "EmulatorConfig":
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)):
                    out[stmt.target.id] = stmt.lineno
    return out


def _perturb(name: str, value):
    """A changed-but-valid value for one config field, or None when the
    checker does not know how (itself a finding: teach it)."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 1
    if isinstance(value, float):
        return value * 2 + 0.25
    if isinstance(value, str):
        from ..core import policies

        menus = {
            "policy": sorted(policies.POLICIES),
            "bank_resolver": ["dense", "segmented", "auto"],
            "chunk_step_kernel": ["on", "off", "auto"],
        }
        menu = menus.get(name)
        if menu:
            return next(v for v in menu if v != value)
    return None


def _runtime_leaves(cfg) -> dict:
    from ..core.config import RuntimeParams

    rp = RuntimeParams.from_config(cfg, device="cpu")
    return dict(zip(rp._fields, rp))


def _engine_key(cfg) -> tuple:
    """The key an ``Engine`` session records its dispatches under."""
    from ..engine import Engine

    return Engine(cfg, device="cpu").static_key


def _check_one_field(findings, base, label, line, make) -> None:
    """Perturb one (sub)field via ``make(base) -> perturbed_cfg`` and
    enforce the completeness and dispatch-key contracts."""
    import torch

    from ..core.config import static_key

    pert = make(base)
    static_changed = static_key(base) != static_key(pert)
    rb, rp = _runtime_leaves(base), _runtime_leaves(pert)
    runtime_changed = any(not torch.equal(rb[f], rp[f]) for f in rb)
    if not static_changed and not runtime_changed:
        findings.append(Finding(
            CONFIG_PATH, line, PASS,
            f"config field `{label}` reaches NEITHER static_key nor "
            "RuntimeParams.from_config — a sweep over this knob is "
            "silently inert"))
        return
    same_key = _engine_key(pert) == _engine_key(base)
    if static_changed and same_key:
        findings.append(Finding(
            CONFIG_PATH, line, PASS,
            f"static field `{label}` does not reach the Engine's dispatch "
            "key — sessions of different geometries would share keys"))
    elif not static_changed and not same_key:
        findings.append(Finding(
            CONFIG_PATH, line, PASS,
            f"runtime field `{label}` leaks into the Engine's dispatch "
            "key — every design point would record keys of its own"))


def check_static_key_completeness(root: pathlib.Path) -> list[Finding]:
    from ..core.config import EmulatorConfig, TechnologyParams

    findings: list[Finding] = []
    linenos = _field_linenos(root / CONFIG_PATH)
    # Small tiers, so every perturbed session is cheap to open.
    base = EmulatorConfig(n_fast_pages=16, n_slow_pages=48)
    for f in dataclasses.fields(EmulatorConfig):
        value = getattr(base, f.name)
        line = linenos.get(f.name, 1)
        if isinstance(value, TechnologyParams):
            for sub in dataclasses.fields(TechnologyParams):
                label = f"{f.name}.{sub.name}"
                if label in INERT_SUBFIELDS:
                    continue
                new = _perturb(sub.name, getattr(value, sub.name))
                if new is None:
                    findings.append(Finding(
                        CONFIG_PATH, line, PASS,
                        f"don't know how to perturb `{label}` — teach "
                        "analysis.staticness._perturb about it"))
                    continue
                _check_one_field(
                    findings, base, label, line,
                    lambda c, f=f, sub=sub, new=new: c.with_(
                        **{f.name: dataclasses.replace(
                            getattr(c, f.name), **{sub.name: new})}))
            continue
        new = _perturb(f.name, value)
        if new is None:
            findings.append(Finding(
                CONFIG_PATH, line, PASS,
                f"don't know how to perturb `{f.name}` — teach "
                "analysis.staticness._perturb about it"))
            continue
        _check_one_field(findings, base, f.name, line,
                         lambda c, f=f, new=new: c.with_(**{f.name: new}))
    return findings


def check_float_fields(root: pathlib.Path) -> list[Finding]:
    """``FLOAT_PARAM_FIELDS`` must be exactly the float32 leaves of
    ``RuntimeParams.from_config`` — the kernel's scalar packing splits
    on it."""
    import torch

    from ..core.config import (FLOAT_PARAM_FIELDS, EmulatorConfig,
                               RuntimeParams)

    rp = RuntimeParams.from_config(EmulatorConfig(), device="cpu")
    floats = {f for f, v in zip(rp._fields, rp) if v.dtype == torch.float32}
    declared = set(FLOAT_PARAM_FIELDS)
    if floats == declared:
        return []
    line = 1
    for i, text in enumerate((root / CONFIG_PATH).read_text().splitlines(),
                             start=1):
        if text.startswith("FLOAT_PARAM_FIELDS"):
            line = i
            break
    return [Finding(
        CONFIG_PATH, line, PASS,
        "FLOAT_PARAM_FIELDS disagrees with the float32 leaves of "
        f"RuntimeParams.from_config (missing={sorted(floats - declared)}, "
        f"extra={sorted(declared - floats)}) — the kernel's scalar "
        "packing will mis-slot")]


def run_repo(root: pathlib.Path) -> list[Finding]:
    findings: list[Finding] = []
    for path in iter_py_files(root):
        # config.py builds RuntimeParams FROM the config on the host; its
        # `p`/`params` names are not per-point tensors.
        if rel(path, root) == CONFIG_PATH:
            continue
        findings += check_file(path)
    findings += check_static_key_completeness(root)
    findings += check_float_fields(root)
    return findings


def run_paths(paths) -> list[Finding]:
    findings: list[Finding] = []
    for path in paths:
        findings += check_file(pathlib.Path(path))
    return findings
