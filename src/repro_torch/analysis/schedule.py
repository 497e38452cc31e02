"""Pass ``schedule`` — the chunk's table schedule, recorded op by op (the
port's counterpart of ``repro.analysis.schedule``, which walks jaxprs).

The contract (``kernels/chunk_step.py``'s module docstring, the JAX
package's PR 7):

  1. every table *read* of the request pipeline (the stage-2 row gather
     and the swap pair) comes before the boundary commit, so it sees the
     pre-chunk table: no table write precedes the commit;
  2. the chunk's writes land in ONE flattened scatter-add over the whole
     table (the boundary commit);
  3. after the commit the only further table writes are the decay (one
     write of the HOTNESS lane) and the retirement's FLAGS stamp (one
     indexed write of the FLAGS lane);
  4. no op copies the whole table.

The pass runs ``kernels.chunk_step.step_batch`` on the CPU under a
``torch.utils._python_dispatch.TorchDispatchMode``, once with
``seq=False`` (the scan path) and once with ``seq=True`` (the plain
version of kernel B), over ``analysis.common.adversarial_step``'s chunks
(every built-in policy a design point). It follows the table by its
storage: a view aliases it, and whether an op writes an argument is read
from the op's schema (``alias_info.is_write``). A write is classified by
the view it writes: the whole table, one lane (every row's lane ``k``,
whose storage offset is ``k``), or a part. Each finding names the source
line (outside PyTorch) that dispatched the op, where an allow-pragma
applies.

Kernel B itself (``csrc/chunk_step.cu``) is held by its bitwise equality
with ``seq=True`` (``chip_smoke.py`` phase 4), where the reference
AST-pins the Pallas body to ``step_ref(seq=True)`` instead.

Fixture protocol: ``reprolint_case()`` returning
``{"kind": "schedule", "make": lambda: (fn, args)}``; ``fn(*args)`` runs
under the recorder with the table as argument 0 (a tensor ``[..., n,
8]``).
"""
from __future__ import annotations

import pathlib
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .common import Finding, adversarial_step, pragma_filter, rel

PASS = "schedule"

# in-place ops that add into their target: the boundary commit's kind
_ACCUMULATE = ("scatter_add_", "index_add_", "scatter_reduce_")


def source_line() -> tuple[str, int]:
    """(path, line) of the innermost frame outside PyTorch and this
    package: the code that dispatched the op."""
    torch_dir = str(pathlib.Path(torch.__file__).parent)
    mine = str(pathlib.Path(__file__).parent)
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if not (name.startswith(torch_dir) or name.startswith(mine)
                or name.startswith("<")):
            return name, f.f_lineno
        f = f.f_back
    return "<unknown>", 0


class TableRecorder(TorchDispatchMode):
    """A dispatch mode that records, in order, every op touching the
    storage of ``table`` (views excluded): ``(kind, op, where, target)``
    with ``kind`` "read", "write" or "copy" (a read that makes a new
    tensor at least the table's size), ``where`` the dispatching source
    line and ``target`` the written view's class ("whole", ("lane", k)
    or "part")."""

    def __init__(self, table):
        super().__init__()
        self.ptr = table.untyped_storage().data_ptr()
        self.numel = table.numel()
        self.width = table.shape[-1]
        self.nbytes = table.untyped_storage().nbytes()
        self.events: list = []

    def _ours(self, t) -> bool:
        return isinstance(t, torch.Tensor) and \
            t.untyped_storage().data_ptr() == self.ptr

    def _target(self, t):
        if t.numel() == self.numel:
            return "whole"
        if t.numel() * self.width == self.numel and \
                t.stride(-1) == self.width:
            return ("lane", t.storage_offset() % self.width)
        return "part"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        reads, writes = False, []
        for i, a in enumerate(func._schema.arguments):
            v = args[i] if i < len(args) else kwargs.get(a.name)
            for t in v if isinstance(v, (list, tuple)) else (v,):
                if self._ours(t):
                    if a.alias_info is not None and a.alias_info.is_write:
                        writes.append(t)
                    else:
                        reads = True
        if not (reads or writes):
            return out
        name = func.__name__.split(".")[0]
        where = source_line()
        for t in writes:
            self.events.append(("write", name, where, self._target(t)))
        if reads and not writes:
            outs = out if isinstance(out, (list, tuple)) else (out,)
            big = any(isinstance(o, torch.Tensor) and not self._ours(o)
                      and o.numel() * o.element_size() >= self.nbytes
                      for o in outs)
            self.events.append(("copy" if big else "read", name, where,
                                None))
        return out


def check_events(events, label: str) -> tuple[list[Finding], dict]:
    """The contract over one recorded step (module docstring): the
    findings, and a summary (reads before the commit, writes after)."""
    from ..core import table as table_lib
    findings: list[Finding] = []

    def bad(where, msg):
        findings.append(Finding(rel(where[0]), where[1], PASS,
                                f"[{label}] {msg}"))

    commit = None
    after = {"decay": 0, "stamp": 0}
    reads_before = 0
    for kind, name, where, target in events:
        if kind == "copy":
            bad(where, f"`{name}` copies the whole table — the chunk "
                "schedule keeps one table and updates it in place")
        elif kind == "read":
            reads_before += commit is None
        elif commit is None:
            if name in _ACCUMULATE and target == "whole":
                commit = where
            else:
                bad(where, f"table write `{name}` before the boundary "
                    "commit — the chunk's reads would see a partially "
                    "written table")
        elif name in _ACCUMULATE and target == "whole":
            bad(where, f"a second boundary commit (`{name}`; the first at "
                f"{rel(commit[0])}:{commit[1]}) — the chunk's writes "
                "must land in ONE scatter-add")
        elif name == "copy_" and target == ("lane", table_lib.HOTNESS) \
                and not after["decay"]:
            after["decay"] += 1
        elif name == "index_put_" and target == ("lane", table_lib.FLAGS) \
                and not after["stamp"]:
            after["stamp"] += 1
        else:
            bad(where, f"table write `{name}` on {target} after the "
                "commit — only the decay and the retirement's FLAGS stamp "
                "may write there")
    return findings, {"label": label, "reads_before_commit": reads_before,
                      "commit": commit is not None, **after}


def record(fn, args) -> list:
    """Run ``fn(*args)`` under a :class:`TableRecorder` on ``args[0]``."""
    with TableRecorder(args[0]) as rec:
        fn(*args)
    return rec.events


def _step_events(seq: bool) -> list:
    from ..core.emulator import _step_scalars
    from ..kernels import chunk_step as cs
    p = adversarial_step()
    st = p["states"]

    def step(table):
        cs.step_batch(p["cfg"], p["registry"], table, p["params"],
                      _step_scalars(st), st.bank_free, *p["chunks"][0],
                      p["faults"], seq=seq)
    return record(step, (st.table,))


#: Filled by run_repo: each program's reads before the commit and the
#: writes after it.
LAST_SUMMARY: list = []


def run_repo(root: pathlib.Path) -> list[Finding]:
    findings: list[Finding] = []
    LAST_SUMMARY.clear()
    for seq, label in ((False, "scan-path"), (True, "plain-kernel-b")):
        f, summary = check_events(_step_events(seq), label)
        LAST_SUMMARY.append(summary)
        findings += f
        if not summary["commit"]:
            findings.append(Finding(
                "src/repro_torch/kernels/chunk_step.py", 1, PASS,
                f"[{label}] no boundary commit (one scatter-add over the "
                "whole table) was recorded"))
        if not summary["reads_before_commit"]:
            findings.append(Finding(
                "src/repro_torch/kernels/chunk_step.py", 1, PASS,
                f"[{label}] no table read before the commit: the "
                "pipeline's stage-2 gather is not where the schedule "
                "puts it"))
    return pragma_filter(findings, root)


def run_paths(paths) -> list[Finding]:
    from .common import fixture_case
    findings: list[Finding] = []
    for path in paths:
        path = pathlib.Path(path)
        case = fixture_case(path)
        if not case or case.get("kind") != PASS:
            continue
        fn, args = case["make"]()
        f, _ = check_events(record(fn, args), path.stem)
        findings += f
    return pragma_filter(findings, pathlib.Path.cwd())
