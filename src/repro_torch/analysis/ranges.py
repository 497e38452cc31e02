"""Pass ``ranges`` — int32 bounds of the packed table and the chunk step
under a declared run budget (the port's counterpart of
``repro.analysis.ranges``).

The reference proves its bounds with an interval interpreter over
jaxprs, which has no counterpart for PyTorch. The port restates what it
proves as checks it can run:

* **the budget** — its own copy of ``N_CHUNKS_BUDGET``, ``PARAM_BOUNDS``
  and ``TRACE_BOUNDS``, and ``validate_budget(cfg)`` on the port's
  ``RuntimeParams``: a leaf missing from ``PARAM_BOUNDS``, or a value
  outside its interval, is a finding;
* **the int32 time horizon** — the port's step evaluated from the time
  origin at the budget's extreme params (every latency at its top,
  every rate at its bottom) on the budget's extreme chunks (the largest
  requests, all on one bank) measures G, the largest growth of a time
  field in one chunk; ``(2^31 - 1) // G`` must cover the budget. An
  evaluation at the corner, not an interval proof: the step is monotone
  in those knobs, and the budget run below checks the rest;
* **index bounds** — ``IndexGuard``, a dispatch mode, holds every index
  into the table (``index``, ``index_put_``, ``gather``, ``scatter*``,
  ``index_select``, ``index_add_``) to ``[0, size)`` on its axis, on the
  adversarial chunks of ``analysis.common.adversarial_step`` (pages 0 and
  ``n_pages - 1``, invalid lanes past either end, a swap in flight),
  through ``step_batch`` with and without ``seq``. PyTorch wraps a
  negative index silently, so an index helper that lost its clamp would
  read another row without an error;
* **saturation over the budget** (``budget_run``, ``saturation``) — the
  HOTNESS and WEAR lanes start just under their caps, the time fields and
  the EPOCH lane just under the int32 horizon this run reaches, the
  summing int counters just under ``2^31 - 1`` less one a request; then
  ``N_CHUNKS_BUDGET`` chunks of an all-write hot trace: each lane must
  saturate at its cap and nothing may wrap. On the CPU a test at
  ``small_platform()``; on the card ``chip_smoke.py`` phase 17, on kernel
  B against its plain version.

``--check`` runs the first three; ``--report`` adds the budget run and
writes the bounds (budget, G, horizon, each lane's end value) under
``proved_bounds``.

Fixture protocol: ``reprolint_case()`` returning
``{"kind": "ranges", "make": lambda: (fn, args)}``; ``fn(*args)`` runs
under ``IndexGuard`` with argument 0 as the table.
"""
from __future__ import annotations

import pathlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .common import Finding, adversarial_step, pragma_filter, rel
from .schedule import source_line

PASS = "ranges"

INT32_MAX = (1 << 31) - 1

# --------------------------------------------------------------------------- #
# The declared per-run budget (the reference's, ranges.py:73-110)
# --------------------------------------------------------------------------- #

#: Chunks per emulation run the int32 bounds cover. With chunk width c,
#: that is ``N_CHUNKS_BUDGET * c`` requests per ``Engine.run`` call.
N_CHUNKS_BUDGET = 1 << 10

#: Declared intervals for every RuntimeParams leaf. A params leaf missing
#: here is itself a finding.
PARAM_BOUNDS = {
    "fast_read_lat": (0, 1 << 11),
    "fast_write_lat": (0, 1 << 11),
    "fast_bytes_per_cycle": (1.0, 1024.0),
    "slow_read_lat": (0, 1 << 11),
    "slow_write_lat": (0, 1 << 11),
    "slow_bytes_per_cycle": (1.0, 1024.0),
    "link_lat": (0, 1 << 11),
    "link_bytes_per_cycle": (1.0, 1024.0),
    "issue_gap": (0, 1 << 8),
    "dma_cycles_per_subblock": (1, 1 << 10),
    "n_fast_pages": (1, None),          # None -> n_pages
    "hot_threshold": (0, 1 << 20),
    "hotness_decay_shift": (0, 31),
    "decay_every": (1, 1 << 20),
    "write_weight": (1, 1 << 10),       # the budget's max_weight
    "wear_slack": (0, 1 << 29),
    "pin_fast_fraction": (0.0, 1.0),
    "endurance_budget": (-(1 << 29), 1 << 29),
    "policy_id": (0, 1 << 4),
    "power_pj_per_bit_fast": (0.0, 1024.0),
    "power_pj_per_bit_slow_read": (0.0, 1024.0),
    "power_pj_per_bit_slow_write": (0.0, 1024.0),
}

#: Request-trace bounds (per field of the chunk).
TRACE_BOUNDS = {
    "page": (0, None),                  # None -> n_pages - 1
    "offset": (0, (1 << 12) - 1),       # within one page
    "size": (0, 1 << 12),               # at most one page per request
}

#: The carry's cycle-valued fields: each grows by at most G a chunk.
TIME_FIELDS = ("clock", "bank_free", "link_free_rx", "link_free_tx",
               "last_return", "dma.start")

#: The int32 counters that add at most one a request.
SUM_COUNTERS = ("reads_fast", "writes_fast", "reads_slow", "writes_slow",
                "n_reads", "reorder_held", "poison_faults",
                "frames_retired", "transient_faults")


def validate_budget(cfg) -> list[str]:
    """The config's design point must sit inside the declared budget."""
    from ..core.config import RuntimeParams
    out = []
    for name, leaf in RuntimeParams.from_config(cfg)._asdict().items():
        if name not in PARAM_BOUNDS:
            out.append(f"params leaf `{name}` missing from PARAM_BOUNDS")
            continue
        lo, hi = PARAM_BOUNDS[name]
        hi = cfg.n_pages if hi is None else hi
        v = float(leaf)
        if not lo <= v <= hi:
            out.append(f"config value {name}={v} outside the declared "
                       f"budget interval [{lo}, {hi}]")
    return out


# --------------------------------------------------------------------------- #
# The int32 time horizon
# --------------------------------------------------------------------------- #

def _field(sc, name: str):
    obj = sc
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def extreme_params(cfg):
    """``cfg``'s design point with every knob that lengthens a chunk at the
    end of its budget interval (latencies at the top, rates at the
    bottom)."""
    from ..core.config import RuntimeParams
    p = RuntimeParams.from_config(cfg)
    top = {k: PARAM_BOUNDS[k][1] for k in (
        "fast_read_lat", "fast_write_lat", "slow_read_lat", "slow_write_lat",
        "link_lat", "issue_gap", "dma_cycles_per_subblock")}
    low = {k: PARAM_BOUNDS[k][0] for k in (
        "fast_bytes_per_cycle", "slow_bytes_per_cycle",
        "link_bytes_per_cycle")}
    return p._replace(**{k: torch.full_like(getattr(p, k), v)
                         for k, v in {**top, **low}.items()})


def _extreme_chunks(cfg) -> dict:
    """Chunks that keep one bank busy with the largest requests: all
    writes, all reads, and both, on one slow page and on the last page."""
    n = cfg.chunk
    i32 = lambda v: torch.full((n,), v, dtype=torch.int32)
    size = i32(TRACE_BOUNDS["size"][1])
    ones = torch.ones(n, dtype=torch.bool)
    alt = torch.arange(n) % 2 == 0
    page = i32(cfg.n_fast_pages)
    last = i32(cfg.n_pages - 1)
    return {"writes": (page, i32(0), ones, size, ones),
            "reads": (page, i32(0), ~ones, size, ones),
            "mixed": (last, i32(0), alt, size, ones)}


def chunk_growth(cfg) -> tuple[int, dict]:
    """(G, each chunk's largest time field after one step from the time
    origin at :func:`extreme_params`)."""
    from ..core.emulator import _step_scalars, init_states
    from ..core.indexing import index_points
    from ..core.policies import PolicyRegistry
    from ..kernels import chunk_step as cs
    params = index_points(extreme_params(cfg), None)
    grown = {}
    for name, chunk in _extreme_chunks(cfg).items():
        st = init_states(cfg, params)
        _, sc, bank_free, _ = cs.step_batch(
            cfg, PolicyRegistry.snapshot(), st.table, params,
            _step_scalars(st), st.bank_free, *(x[None] for x in chunk))
        grown[name] = max(int(bank_free.max()), *(
            int(_field(sc, f).max()) for f in TIME_FIELDS
            if f != "bank_free"))
    return max(1, *grown.values()), grown


def horizon(cfg) -> dict:
    g, grown = chunk_growth(cfg)
    return {"n_chunks_budget": N_CHUNKS_BUDGET, "per_chunk_growth": g,
            "int32_horizon_chunks": INT32_MAX // g, "by_chunk": grown}


# --------------------------------------------------------------------------- #
# Index bounds
# --------------------------------------------------------------------------- #

# op name -> how its index arguments are read: "list" (a list of
# per-dimension indices), or the name of its ``dim`` argument
_INDEXED = {"index": "list", "index_put_": "list", "index_put": "list",
            "_index_put_impl_": "list", "gather": "dim", "scatter": "dim",
            "scatter_": "dim", "scatter_add": "dim", "scatter_add_": "dim",
            "scatter_reduce": "dim", "scatter_reduce_": "dim",
            "index_select": "dim", "index_add": "dim", "index_add_": "dim"}


class IndexGuard(TorchDispatchMode):
    """A dispatch mode holding every integer index into a tensor that
    aliases ``table``'s storage to ``[0, size)`` of its axis. Each index
    out of it is kept in ``bad`` as (source line, message); ``n_checked``
    counts the index tensors held."""

    def __init__(self, table):
        super().__init__()
        self.ptr = table.untyped_storage().data_ptr()
        self.bad: list = []
        self.n_checked = 0

    def _hold(self, func, base, dim, idx):
        if not isinstance(idx, torch.Tensor) or idx.dtype == torch.bool \
                or idx.numel() == 0:
            return
        self.n_checked += 1
        n = base.shape[dim]
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= n:
            self.bad.append((source_line(), (
                f"`{func.__name__.split('.')[0]}` indexes the table's axis "
                f"{dim} of {n} with [{lo}, {hi}] — out of bounds"
                + (" (a negative index wraps silently)" if lo < 0 else ""))))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__.split(".")[0]
        how = _INDEXED.get(name)
        base = args[0] if args else None
        if how and isinstance(base, torch.Tensor) and \
                base.untyped_storage().data_ptr() == self.ptr:
            if how == "list":
                indices = args[1] if len(args) > 1 else kwargs["indices"]
                for d, idx in enumerate(indices):
                    self._hold(func, base, d, idx)
            else:
                dim = args[1] if len(args) > 1 else kwargs["dim"]
                idx = args[2] if len(args) > 2 else kwargs["index"]
                self._hold(func, base, dim % base.dim(), idx)
        return func(*args, **kwargs)


def guarded(fn, args) -> IndexGuard:
    """Run ``fn(*args)`` under an :class:`IndexGuard` on ``args[0]``."""
    with IndexGuard(args[0]) as guard:
        fn(*args)
    return guard


def check_indices() -> tuple[list[Finding], dict]:
    """Every table index of ``step_batch`` (``seq`` False and True) in
    bounds over the adversarial chunks."""
    from ..core.emulator import _step_scalars
    from ..kernels import chunk_step as cs
    findings: list[Finding] = []
    checked = {}
    for seq, label in ((False, "scan-path"), (True, "plain-kernel-b")):
        p = adversarial_step()
        st = p["states"]

        def run(table):
            sc, bank_free = _step_scalars(st), st.bank_free
            for chunk in p["chunks"]:
                _, sc, bank_free, _ = cs.step_batch(
                    p["cfg"], p["registry"], table, p["params"], sc,
                    bank_free, *chunk, p["faults"], seq=seq)
        guard = guarded(run, (st.table,))
        checked[label] = guard.n_checked
        for (path, line), msg in guard.bad:
            findings.append(Finding(rel(path), line, PASS,
                                    f"[{label}] {msg}"))
    return findings, checked


# --------------------------------------------------------------------------- #
# Saturation over the budget
# --------------------------------------------------------------------------- #

def budget_config(cfg=None):
    """The budget run's platform: no decay over the budget, no
    retirement, ``hotness`` migrating."""
    from ..core import small_platform
    cfg = cfg or small_platform()
    return cfg.with_(decay_every=PARAM_BOUNDS["decay_every"][1],
                     endurance_budget=0, policy="hotness", hot_threshold=2)


def budget_trace(cfg, n_chunks: int, device="cpu"):
    """``n_chunks`` chunks of writes cycling over four slow pages."""
    from ..core import Trace
    n = n_chunks * cfg.chunk
    i = torch.arange(n, dtype=torch.int32, device=device)
    return Trace(page=cfg.n_fast_pages + i % 4, offset=(i % 8) * 64,
                 is_write=torch.ones(n, dtype=torch.bool, device=device),
                 size=torch.full((n,), cfg.line_size, dtype=torch.int32,
                                 device=device))


def budget_state(cfg, params, time0: int, n_requests: int):
    """The start state: HOTNESS and WEAR three under their caps, the time
    fields and the EPOCH lane at ``time0``, the summing int counters at
    ``2^31 - 1 - n_requests``."""
    from ..core import table as table_lib
    from ..core.emulator import init_state
    from ..core.indexing import put_lane_
    st = init_state(cfg, params)
    rows = torch.arange(cfg.n_pages, device=st.table.device)
    for lane, v in ((table_lib.HOTNESS, table_lib.HOTNESS_CAP - 3),
                    (table_lib.WEAR, table_lib.WEAR_CAP - 3),
                    (table_lib.EPOCH, time0)):
        put_lane_(st.table, rows, lane, torch.full_like(rows, v,
                                                        dtype=torch.int32))
    for f in TIME_FIELDS:
        _field(st, f).fill_(time0)
    for f in SUM_COUNTERS:
        getattr(st.counters, f).fill_(INT32_MAX - n_requests)
    return st


def budget_run(cfg, n_chunks: int = N_CHUNKS_BUDGET, *, device="cpu",
               seq: bool = False, time0: int | None = None):
    """The budget run through ``core.emulator._emulate_impl`` (kernel B
    where ``cfg`` picks it on a card; ``seq=True`` its plain version).
    ``time0`` None: first run from the time origin, and start just under
    the horizon that run reached. Returns ``(state, outs, time0)``."""
    from ..core.emulator import _emulate_impl
    from ..core.policies import PolicyRegistry
    from ..core.config import RuntimeParams
    params = RuntimeParams.from_config(cfg, device=device)
    registry = PolicyRegistry.snapshot()
    trace = budget_trace(cfg, n_chunks, device)
    valid = torch.ones(len(trace), dtype=torch.bool, device=device)
    n = len(trace)
    if time0 is None:
        st, _ = _emulate_impl(cfg, registry, trace, valid,
                              budget_state(cfg, params, 0, n), params,
                              seq=seq)
        time0 = INT32_MAX - _time_top(st)
    st, outs = _emulate_impl(cfg, registry, trace, valid,
                             budget_state(cfg, params, time0, n), params,
                             seq=seq)
    return st, outs, time0


def _time_top(st) -> int:
    return max(int(_field(st, f).max()) for f in TIME_FIELDS)


def saturation(st, time0: int, n_requests: int) -> tuple[list[str], dict]:
    """(problems, end values) of a budget run's final state: HOTNESS and
    WEAR at their caps and in ``[0, cap]``; EPOCH and the time fields in
    ``[time0, 2^31 - 1]``; each summing counter in ``[2^31 - 1 -
    n_requests, 2^31 - 1]``."""
    from ..core import table as table_lib
    problems = []
    ends = {}
    for name, lane, lo, hi, full in (
            ("HOTNESS", table_lib.HOTNESS, 0, table_lib.HOTNESS_CAP, True),
            ("WEAR", table_lib.WEAR, 0, table_lib.WEAR_CAP, True),
            ("EPOCH", table_lib.EPOCH, time0, INT32_MAX, False)):
        col = st.table[..., lane]
        a, b = int(col.min()), int(col.max())
        ends[name] = [a, b]
        if a < lo or b > hi:
            problems.append(f"{name} lane in [{a}, {b}], outside "
                            f"[{lo}, {hi}]: it wrapped")
        elif full and b != hi:
            problems.append(f"{name} lane ends at {b}, not saturated at "
                            f"its cap {hi}")
    for f in TIME_FIELDS:
        x = _field(st, f)
        a, b = int(x.min()), int(x.max())
        ends[f] = b
        if a < time0:
            problems.append(f"time field {f} at {a}, under its start "
                            f"{time0}: it wrapped")
    for f in SUM_COUNTERS:
        v = int(getattr(st.counters, f))
        ends[f"counters.{f}"] = v
        if v < INT32_MAX - n_requests:
            problems.append(f"counter {f} at {v}: it wrapped")
    ends["swaps_done"] = int(st.dma.swaps_done)
    return problems, ends


# --------------------------------------------------------------------------- #
# Repo entry points
# --------------------------------------------------------------------------- #

#: Filled by run_repo (and :func:`report_bounds`): the bounds the CLI's
#: ``--report`` writes under "proved_bounds".
LAST_BOUNDS: list = []

_HERE = "src/repro_torch/analysis/ranges.py"


def run_repo(root: pathlib.Path) -> list[Finding]:
    from ..core import small_platform
    cfg = small_platform()
    findings: list[Finding] = []
    LAST_BOUNDS.clear()
    for msg in validate_budget(cfg):
        findings.append(Finding(_HERE, 1, PASS, msg))
    h = horizon(cfg)
    if h["int32_horizon_chunks"] < N_CHUNKS_BUDGET:
        findings.append(Finding(_HERE, 1, PASS, (
            f"int32 clock horizon is {h['int32_horizon_chunks']} chunks "
            f"(per-chunk growth {h['per_chunk_growth']}) but the declared "
            f"budget is {N_CHUNKS_BUDGET} chunks — a budgeted run can "
            "overflow the cycle counters")))
    f, checked = check_indices()
    findings += pragma_filter(f, root)
    LAST_BOUNDS.append({"label": "small_platform", **h,
                        "table_indices_checked": checked})
    return findings


def report_bounds(cfg=None) -> dict:
    """The budget run at ``budget_config(cfg)`` on the CPU: its start, its
    problems and each lane's and field's end value (appended to
    ``LAST_BOUNDS``)."""
    cfg = budget_config(cfg)
    st, _, time0 = budget_run(cfg)
    problems, ends = saturation(st, time0, N_CHUNKS_BUDGET * cfg.chunk)
    out = {"label": "budget_run", "chunk": cfg.chunk,
           "n_chunks": N_CHUNKS_BUDGET, "time0": time0,
           "problems": problems, "ends": ends}
    LAST_BOUNDS.append(out)
    return out


def run_paths(paths) -> list[Finding]:
    from .common import fixture_case
    findings: list[Finding] = []
    for path in paths:
        path = pathlib.Path(path)
        case = fixture_case(path)
        if not case or case.get("kind") != PASS:
            continue
        fn, args = case["make"]()
        for (src, line), msg in guarded(fn, args).bad:
            findings.append(Finding(rel(src), line, PASS,
                                    f"[{path.stem}] {msg}"))
    return pragma_filter(findings, pathlib.Path.cwd())
