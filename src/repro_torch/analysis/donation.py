"""Pass ``donation`` — a consumed (donated) state's memory really carries
the result, and callers do not read a name after donating it (the port's
counterpart of ``repro.analysis.donation``).

The port's donation is in place: ``Engine.run`` / ``run_stream`` /
``continue_sweep`` update a passed state's tensors and hand back new
tensor objects over the same memory, marking the passed ones consumed
(``engine._renew``). Three checks:

  * **storage identity** (in place of the reference's stablehlo aliasing
    check): at every registered site, on the CPU at a small geometry,
    each tensor of the result keeps the passed state's
    ``untyped_storage().data_ptr()`` — across ``run``, ``run_stream`` and
    ``continue_sweep``, ``core.emulator._emulate_impl``,
    ``kernels.chunk_step.step_batch``, ``memtier``'s carried state and
    ``serve.contracts``' stamps. A run that silently copied the state
    would keep the result right and lose the memory it was donated for:
    only this check sees it. (``chip_smoke.py`` phase 17 holds it on
    kernel B.)
  * **site registry** (AST): a call to one of the functions that update
    a passed state's memory in place (``UPDATERS``) in a module of the
    port outside ``REGISTERED_SITES`` is a finding (or carries a
    ``# reprolint: allow[donation]`` pragma saying why it is exempt).
  * **read-after-donate** (AST, the reference's as it is): after a
    statement passes a name as a donated argument (``state=``/
    ``states=`` keyword to a session-API call without ``donate=False``,
    the first argument of ``continue_sweep``, or any call with
    ``donate=True``), a later read of that name — without an
    intervening rebind — is a finding.

Fixture protocol: ``reprolint_case()`` returning
``{"kind": "donation", "make": lambda: (fn, state)}``; ``fn(state)``
returns the new state, and each of its tensors must keep the passed
state's storage.
"""
from __future__ import annotations

import ast
import pathlib

import torch
from torch.utils._pytree import tree_flatten

from .common import Finding, apply_pragmas, iter_py_files, rel

PASS = "donation"

#: The port's modules that update a passed state in place, each held by
#: a storage-identity check below.
REGISTERED_SITES = {
    "src/repro_torch/engine.py",
    "src/repro_torch/core/emulator.py",
    "src/repro_torch/kernels/chunk_step.py",
    "src/repro_torch/memtier/tiered_cache.py",
    "src/repro_torch/serve/contracts.py",
}

#: Calls that update a passed state's (or table's) memory in place.
UPDATERS = ("_renew", "_emulate_impl", "_emulate_batch_impl", "step_batch",
            "chunk_step_cuda", "_stamp", "_release")


def _ptrs(tree) -> list:
    return [t.untyped_storage().data_ptr() for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


def kept_storage(before, after) -> list[int]:
    """The positions of ``after``'s tensors whose storage is not the one
    ``before``'s tensor at that position had (an empty list: the result
    lives in the passed state's memory)."""
    a, b = _ptrs(before), _ptrs(after)
    if len(a) != len(b):
        return list(range(max(len(a), len(b))))
    return [i for i, (x, y) in enumerate(zip(a, b)) if x != y]


def _probe():
    from .. import Engine
    from ..core import Trace, small_platform
    cfg = small_platform(n_fast_pages=4, n_slow_pages=28, chunk=8,
                         hot_threshold=1)
    n = 40
    i = torch.arange(n, dtype=torch.int32)
    trace = Trace(page=(i * 7) % cfg.n_pages, offset=(i % 8) * 64,
                  is_write=i % 3 == 0, size=torch.full((n,), 64,
                                                       dtype=torch.int32))
    return cfg, Engine(cfg, device="cpu"), trace


def check_repo_storage() -> list[Finding]:
    """Each registered site's result in the passed state's memory."""
    from ..core import Trace
    from ..core import emulator as emu
    from ..core.emulator import _step_scalars
    from ..core.indexing import index_points
    from ..kernels import chunk_step as cs
    from ..memtier import TieredKVAccounting
    from ..serve import contracts
    from ..sweep import SweepSpec

    cfg, eng, trace = _probe()
    checks = []

    def hold(site, what, before, run):
        ptrs = _ptrs(before)
        after = run()
        moved = [i for i, (x, y) in enumerate(zip(ptrs, _ptrs(after)))
                 if x != y]
        if moved or len(ptrs) != len(_ptrs(after)):
            checks.append(Finding(
                site, 1, PASS,
                f"{what}: {len(moved) or 'all'} tensor(s) of the result "
                "left the passed state's memory — the state was copied, "
                "not donated"))
        return after

    engine_py = "src/repro_torch/engine.py"
    state = eng.run(trace).state
    state = hold(engine_py, "Engine.run(state=)", state,
                 lambda: eng.run(trace, state=state).state)
    halves = [Trace(*(x[:13] for x in trace)),
              Trace(*(x[13:] for x in trace))]
    hold(engine_py, "Engine.run_stream(state=)", state,
         lambda: eng.run_stream(halves, state=state).state)
    sweep = eng.sweep(SweepSpec(base=cfg, policies=("hotness", "static")),
                      trace)
    hold(engine_py, "Engine.continue_sweep", sweep.states,
         lambda: eng.continue_sweep(sweep, trace).states)

    st = emu.init_state(cfg)
    padded, valid = emu.pad_trace(cfg, trace)
    hold("src/repro_torch/core/emulator.py", "_emulate_impl", st,
         lambda: emu._emulate_impl(cfg, eng.registry, padded, valid, st,
                                   eng.params, emu.FaultPlan.empty())[0])
    params = index_points(eng.params, None)
    sts = emu.init_states(cfg, params)
    hold("src/repro_torch/kernels/chunk_step.py", "step_batch", sts.table,
         lambda: cs.step_batch(
             cfg, eng.registry, sts.table, params, _step_scalars(sts),
             sts.bank_free, *(x[None, :cfg.chunk] for x in padded),
             valid[None, :cfg.chunk])[0])

    tier = TieredKVAccounting(cfg, n_layers=1, positions_per_page=4,
                              device="cpu")
    tier.account(trace)
    before = tier.state
    hold("src/repro_torch/memtier/tiered_cache.py",
         "TieredKVAccounting.account", before,
         lambda: (tier.account(trace), tier.state)[1])
    hold("src/repro_torch/serve/contracts.py", "stamp_pin_pages",
         tier.state, lambda: contracts.stamp_pin_pages(tier.state, [1, 2]))
    return checks


# --- AST checks -----------------------------------------------------------


def _is_false(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is False


def _donated_names(call: ast.Call) -> list[str]:
    """Names a call consumes under the donation conventions."""
    kw = {k.arg: k.value for k in call.keywords if k.arg}
    if _is_false(kw.get("donate")):
        return []
    out = []
    explicit = isinstance(kw.get("donate"), ast.Constant) and \
        kw["donate"].value is True
    for name in ("state", "states"):
        v = kw.get(name)
        if isinstance(v, ast.Name):
            fn = call.func
            session_call = (isinstance(fn, ast.Attribute) and fn.attr in
                            ("run", "run_stream", "run_channels", "sweep",
                             "continue_sweep"))
            if session_call or explicit:
                out.append(v.id)
    if (isinstance(call.func, ast.Attribute)
            and call.func.attr == "continue_sweep" and call.args
            and isinstance(call.args[0], ast.Name)):
        out.append(call.args[0].id)
    return out


def _assigned_names(stmt) -> set[str]:
    out: set[str] = set()
    targets = []
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign, ast.For)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.With):
        targets = [i.optional_vars for i in stmt.items if i.optional_vars]
    for t in targets:
        for node in ast.walk(t):
            if isinstance(node, ast.Name):
                out.add(node.id)
    return out


def _linearize(stmts):
    """Flatten a statement list into source-order (kind, node) units:
    simple statements as a whole, compound statements as their header
    expression plus their recursively flattened bodies. Nested function
    definitions are skipped — each gets its own visit."""
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(stmt, (ast.If, ast.While)):
            yield "expr", stmt.test
            yield from _linearize(stmt.body)
            yield from _linearize(stmt.orelse)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            yield "expr", stmt.iter
            yield "bind", stmt.target
            yield from _linearize(stmt.body)
            yield from _linearize(stmt.orelse)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                yield "expr", item.context_expr
                if item.optional_vars is not None:
                    yield "bind", item.optional_vars
            yield from _linearize(stmt.body)
        elif isinstance(stmt, ast.Try):
            yield from _linearize(stmt.body)
            for h in stmt.handlers:
                yield from _linearize(h.body)
            yield from _linearize(stmt.orelse)
            yield from _linearize(stmt.finalbody)
        else:
            yield "stmt", stmt


def _check_read_after_donate(tree: ast.AST, path: str) -> list[Finding]:
    findings: list[Finding] = []

    def visit_function(fn):
        donated: dict[str, int] = {}  # name -> donating line
        for kind, node in _linearize(fn.body):
            if kind == "bind":
                for n in ast.walk(node):
                    if isinstance(n, ast.Name):
                        donated.pop(n.id, None)
                continue
            # reads of currently-donated names (checked before this
            # unit's own donations take effect)
            for n in ast.walk(node):
                if (isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                        and n.id in donated):
                    findings.append(Finding(
                        path, n.lineno, PASS,
                        f"`{n.id}` read after being donated on line "
                        f"{donated[n.id]} — donated buffers are "
                        "consumed; rebind the result instead"))
                    donated.pop(n.id)
            new_donations = []
            for call in ast.walk(node):
                if isinstance(call, ast.Call):
                    for name in _donated_names(call):
                        new_donations.append((name, node.lineno))
            bound = _assigned_names(node) if kind == "stmt" else set()
            for name in bound:
                donated.pop(name, None)
            for name, line in new_donations:
                # a donating statement that rebinds the same name
                # (state, outs = eng.run(..., state=state)) is the
                # canonical safe pattern
                if name not in bound:
                    donated[name] = line

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            visit_function(node)
    return findings


def _check_site_registry(tree: ast.AST, path: str) -> list[Finding]:
    if path in REGISTERED_SITES or not path.startswith("src/repro_torch/"):
        return []
    findings = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            if name in UPDATERS:
                findings.append(Finding(
                    path, node.lineno, PASS,
                    f"unregistered in-place state update `{name}` — add "
                    "the module to analysis.donation.REGISTERED_SITES (with "
                    "a storage-identity check) or pragma-allowlist it"))
    return findings


def check_file(path: pathlib.Path) -> list[Finding]:
    source = path.read_text()
    tree = ast.parse(source)
    p = rel(path)
    findings = _check_read_after_donate(tree, p)
    findings += _check_site_registry(tree, p)
    return apply_pragmas(findings, source)


def run_repo(root: pathlib.Path) -> list[Finding]:
    findings: list[Finding] = []
    for path in iter_py_files(root):
        findings += check_file(path)
    findings += check_repo_storage()
    return findings


def run_paths(paths) -> list[Finding]:
    from .common import fixture_case

    findings: list[Finding] = []
    for path in paths:
        path = pathlib.Path(path)
        findings += check_file(path)
        case = fixture_case(path)
        if case and case.get("kind") == PASS:
            fn, state = case["make"]()
            moved = kept_storage(state, fn(state))
            if moved:
                findings += apply_pragmas([Finding(
                    rel(path), case.get("line", 1), PASS,
                    f"donation dropped: {len(moved)} tensor(s) of the "
                    "result are not in the passed state's memory")],
                    path.read_text())
    return findings
