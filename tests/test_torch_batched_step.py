"""The plain chunk step with a point axis: B design points in one step.

``kernels.chunk_step.step_batch`` runs B points at once (the JAX
package's ``vmap`` written out as a leading axis). Here it is held, bit
for bit, against each point's ``step_ref`` alone (which the kernel tests
hold against the JAX package's), from the adversarial state with a
stacked fault plan, on both bank resolvers; the port's sweep over all
six policies against ``repro.Engine.sweep``; every core module's point
axis against its one-point calls; the fused gather's plain entry
against the interpreted Pallas kernel; and, with a spy on
``ops.hmmu_lookup_fused``, that the scan path gathers ONE time a chunk
whatever the number of points (the CPU's stand-in for the card's count
of kernel-A launches). Inputs come from numpy seeds.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jcore
from repro.core import faults as j_faults
from repro.sweep import SweepSpec as JSpec

import repro_torch
import repro_torch.core as tcore
from repro_torch.core import consistency as t_cons, counters as t_ctr
from repro_torch.core import dma as t_dma, emulator as t_emu
from repro_torch.core import faults as t_faults, indexing as t_idx
from repro_torch.core import latency as t_lat, policies as t_pol
from repro_torch.core import table as t_table
from repro_torch.core.policies import PolicyRegistry
from repro_torch.kernels import chunk_step as tcs, hmmu_lookup as t_hl
from repro_torch.kernels import ops as t_ops, ref as t_ref
from repro_torch.sweep import SweepSpec as TSpec

from conftest import make_trace_arrays
from test_torch_core import POLICIES, T, assert_same, random_table

j_hl = importlib.import_module("repro.kernels.hmmu_lookup")

point = t_idx.index_points


def stacked(xs):
    """Stack a list of (nested) NamedTuples of tensors along a new axis."""
    if isinstance(xs[0], tuple):
        return type(xs[0])(*(stacked(list(y)) for y in zip(*xs)))
    return torch.stack(xs)


# ------------------------------------------------------ the step at B = 7
# (registry, the seven points' policy_ids): the six built-ins, and one id
# past the registry's end (its last policy, clamped; no write weighting).
REGISTRIES = {
    "full": (POLICIES, [0, 1, 2, 3, 4, 5, 9]),
    "subset": (("stream", "hotness_global", "write_bias"),
               [0, 1, 2, 2, 1, 0, 5]),
}


def _points(cfg, ids):
    """Seven design points with their own tier split, threshold, link and
    slow-tier latencies, endurance budget and policy_id."""
    base = cfg.runtime()
    out = []
    for i, pid in enumerate(ids):
        out.append(base._replace(
            n_fast_pages=torch.tensor(8 + 2 * (i % 3) - 2 * (i % 2),
                                      dtype=torch.int32),
            hot_threshold=torch.tensor(1 + i % 3, dtype=torch.int32),
            link_lat=torch.tensor(40 + 37 * i, dtype=torch.int32),
            slow_read_lat=torch.tensor(100 + 50 * i, dtype=torch.int32),
            slow_write_lat=torch.tensor(275 + 90 * (i % 4),
                                        dtype=torch.int32),
            endurance_budget=torch.tensor(2 if i % 3 else 0,
                                          dtype=torch.int32),
            write_weight=torch.tensor(3, dtype=torch.int32),
            policy_id=torch.tensor(pid, dtype=torch.int32)))
    return out


def _adversarial(cfg, p):
    """A point's start state: pins, a poisoned page and a swap in flight
    (``tests/test_endurance.py``'s scenario at the point's tier split)."""
    nf = int(p.n_fast_pages)
    st = t_emu.init_state(cfg, p)
    tab = t_table.set_flags(st.table, [0, 1], t_table.PIN_FAST)
    tab = t_table.set_flags(tab, [nf + 1], t_table.PIN_SLOW)
    tab = t_table.set_flags(tab, [nf + 3], t_table.POISONED)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    return st._replace(table=tab, dma=st.dma._replace(
        active=i32(1), page_a=i32(nf + 2), page_b=i32(nf - 1), start=i32(0)))


def _chunks(cfg, seed, n_chunks, n_points, shared):
    rng = np.random.default_rng(seed)
    n = n_chunks * cfg.chunk
    rows = []
    for _ in range(1 if shared else n_points):
        page = np.where(rng.random(n) < 0.5, 6 + rng.integers(0, 8, n),
                        rng.integers(-2, cfg.n_pages + 2, n)).astype(np.int32)
        page[rng.random(n) < 0.2] = 10    # swap member a at the base split
        off = (rng.integers(0, cfg.page_size // 64, n) * 64).astype(np.int32)
        iw = rng.random(n) < 0.5
        size = rng.choice([64, 128, 4096], n).astype(np.int32)
        valid = np.ones(n, bool)
        valid[-3:] = False
        rows.append([T(x) for x in (page, off, iw, size, valid)])
    return rows


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("registry", sorted(REGISTRIES))
@pytest.mark.parametrize("resolver", ["dense", "segmented"])
def test_batched_step_equals_each_point_alone(resolver, registry, seq):
    """Four chunks of ``step_batch`` over seven points against each
    point's ``step_ref`` alone, after every chunk: tables, scalars,
    ``bank_free`` and outputs, bit for bit."""
    cfg = tcore.small_platform(chunk=16, decay_every=2, bank_resolver=resolver)
    names, ids = REGISTRIES[registry]
    reg = PolicyRegistry.snapshot(names)
    params = _points(cfg, ids)
    starts = [_adversarial(cfg, p) for p in params]
    plans = [t_faults.pad_plan(t_faults.seeded_plan(
        i, pages=np.arange(int(p.n_fast_pages), cfg.n_pages), n_chunks=4,
        n_deaths=1 + i % 2, n_transient=3 + i), 12, 3)
        for i, p in enumerate(params)]
    shared = registry == "full"   # one chunk for all, or one a point
    rows = _chunks(cfg, 3, 4, len(params), shared)
    alone = [(s.table.clone(), tcs.StepScalars(
        s.clock, s.clock_ptr, s.chunk_idx, s.dma, s.link_free_rx,
        s.link_free_tx, s.last_return, s.rescue_page, s.min_wear,
        s.fault_cursor), s.bank_free) for s in starts]
    table = torch.stack([s.table for s in starts])
    sc = stacked([a[1] for a in alone])
    bank_free = torch.stack([s.bank_free for s in starts])
    bparams, bplan = stacked(params), t_faults.stack_plans(plans)
    fired = {"retired": 0, "injected": 0, "tombstone": 0}
    for c in range(4):
        sl = slice(c * cfg.chunk, (c + 1) * cfg.chunk)
        vec = [torch.stack([r[k][sl] for r in rows]).expand(len(params), -1)
               for k in range(5)]
        table, sc, bank_free, outs = tcs.step_batch(
            cfg, reg, table, bparams, sc, bank_free, *vec, bplan, seq=seq)
        for i, p in enumerate(params):
            t, s, bf = alone[i]
            r = rows[0 if shared else i]
            t, s, bf, o = tcs.step_ref(cfg, reg, t, p, s, bf,
                                       *(x[sl] for x in r), plans[i],
                                       seq=seq)
            alone[i] = (t, s, bf)
            where = f"chunk {c} point {i} (policy_id {ids[i]})"
            assert_same(t, table[i], f"{where} table")
            assert_same(s, point(sc, i), f"{where} scalars")
            assert_same(bf, bank_free[i], f"{where} bank_free")
            assert_same(o, {k: v[i] for k, v in outs.items()},
                        f"{where} outs")
            fired["retired"] += int(o["retired"]) >= 0
            fired["tombstone"] += int(o["tombstone"]) >= 0
            fired["injected"] += int(o["injected"].sum())
    assert fired["retired"] and fired["injected"], fired
    assert int(sc.dma.swaps_done.sum()) > 0


# ------------------------------------------- the sweep against the JAX one
@pytest.mark.parametrize("plan", ["shared", "stacked"])
def test_cpu_sweep_of_every_policy_matches_jax(plan):
    """``Engine(device="cpu").sweep`` over the six policies x two tier
    splits, and ``continue_sweep`` on from it, against ``repro``'s, field
    by field, under endurance retirement and a shared or stacked plan."""
    kw = dict(chunk=8, hot_threshold=2, decay_every=4, write_weight=3,
              endurance_budget=3)
    cfg_j, cfg_t = jcore.small_platform(**kw), tcore.small_platform(**kw)
    axes = dict(policies=POLICIES, fast_fractions=(0.125, 0.25),
                link_lats=(40,))
    jspec, tspec = JSpec(base=cfg_j, **axes), TSpec(base=cfg_t, **axes)
    arrays = make_trace_arrays(cfg_j, 61, np.random.default_rng(21),
                               hot_fraction=0.4)
    jt = jcore.Trace(*map(jnp.asarray, arrays))
    tt = tcore.Trace(*map(T, arrays))
    n_chunks = 2 * -(-61 // 8)
    if plan == "shared":
        jplan = j_faults.seeded_plan(5, pages=np.arange(8, 12),
                                     n_chunks=n_chunks, n_deaths=3,
                                     n_transient=6)
        tplan = t_faults.FaultPlan(*map(T, jplan))
    else:
        plans = [j_faults.pad_plan(j_faults.seeded_plan(
            i, pages=np.arange(8, 12), n_chunks=n_chunks, n_deaths=i % 3,
            n_transient=2 + i % 4), 6, 3) for i in range(12)]
        jplan = j_faults.stack_plans(plans)
        tplan = t_faults.FaultPlan(*map(T, jplan))
    jeng, teng = repro.Engine(cfg_j), repro_torch.Engine(cfg_t, device="cpu")
    jres = jeng.sweep(jspec, jt, faults=jplan)
    tres = teng.sweep(tspec, tt, faults=tplan)
    assert_same(jres.states, tres.states, "sweep states")
    assert_same(jres.outs, tres.outs, "sweep outs")
    jcont = jeng.continue_sweep(jres, jt, faults=jplan)
    tcont = teng.continue_sweep(tres, tt, faults=tplan)
    assert_same(jcont.states, tcont.states, "continued states")
    assert_same(jcont.outs, tcont.outs, "continued outs")
    c = tcont.states.counters
    assert int(c.frames_retired.sum()) > 0
    assert int(c.transient_faults.sum()) > 0


# ------------------------------------------- one gather a chunk, any B
@pytest.mark.parametrize("b", [1, 4, 16])
def test_one_fused_gather_a_chunk_whatever_b(b, monkeypatch):
    """The scan path's stage-2 gather runs once a chunk for all B points
    (on a card: one kernel-A launch), on ``sweep``, ``continue_sweep``,
    ``run_channels`` and ``run``; each call gathers every point's rows."""
    cfg = tcore.small_platform(chunk=8, hot_threshold=2)
    eng = repro_torch.Engine(cfg, device="cpu")
    arrays = make_trace_arrays(cfg, 40, np.random.default_rng(b))
    trace = tcore.Trace(*map(T, arrays))
    n_chunks = 5
    calls = []
    real = t_ops.hmmu_lookup_fused

    def spy(table, pages, page_a, page_b):
        calls.append((tuple(table.shape), tuple(pages.shape),
                      tuple(page_a.shape)))
        return real(table, pages, page_a, page_b)

    monkeypatch.setattr(t_ops, "hmmu_lookup_fused", spy)
    params = stacked([cfg.with_(hot_threshold=1 + i % 4,
                                policy=POLICIES[i % 6]).runtime()
                      for i in range(b)])
    res = eng.sweep(params, trace)
    eng.continue_sweep(res, trace)
    chans = tcore.Trace(*(x.expand(b, -1).contiguous() for x in trace))
    eng.run_channels(chans)
    eng.run(trace)
    want = [((b, cfg.n_pages, 8), (b, cfg.chunk), (b,))] * (3 * n_chunks) + \
        [((1, cfg.n_pages, 8), (1, cfg.chunk), (1,))] * n_chunks
    assert calls == want


# ------------------------------------------- the fused gather's plain entry
def test_fused_plain_entry_matches_interpreted_pallas():
    """Raw DMA registers (idle -1, negative, past the end) through the
    fused plain entry against the JAX fused kernel (interpret mode) on
    ``stack([a, b])``, with and without a point axis, and a chunk shared
    by every point as an expanded view."""
    rng = np.random.default_rng(8)
    b, n_pages, m = 5, 40, 12
    table = rng.integers(-50, 1000, (b, n_pages, 8)).astype(np.int32)
    pages = rng.integers(-3, n_pages + 3, (b, m)).astype(np.int32)
    pages[:, :3] = [-1, n_pages, 10 * n_pages]
    page_a = np.array([-1, -7, n_pages, 3, 10 * n_pages], np.int32)
    page_b = np.array([n_pages - 1, -1, 0, -n_pages - 2, 17], np.int32)
    want = j_hl.hmmu_lookup_fused(
        jnp.asarray(table), jnp.asarray(pages),
        jnp.asarray(np.stack([page_a, page_b], -1)), interpret=True)
    got = t_ops.hmmu_lookup_fused(T(table), T(pages), T(page_a), T(page_b))
    assert_same(want, got, "fused, B points")
    assert_same(t_ref.fused_gather(t_ref.hmmu_lookup, T(table), T(pages),
                                   T(np.stack([page_a, page_b], -1))),
                got, "fused_gather")
    one = t_ops.hmmu_lookup_fused(T(table[1]), T(pages[1]), T(page_a[1]),
                                  T(page_b[1]))
    assert_same((want[0][1], want[1][1]), one, "one point")
    shared = T(pages[2]).expand(b, -1)
    want = j_hl.hmmu_lookup_fused(
        jnp.asarray(table), jnp.asarray(np.broadcast_to(pages[2], (b, m))),
        jnp.asarray(np.stack([page_a, page_b], -1)), interpret=True)
    assert_same(want, t_ops.hmmu_lookup_fused(T(table), shared, T(page_a),
                                              T(page_b)), "shared chunk")


def test_fused_cuda_wrapper_rejects_cpu_tensors():
    table = torch.zeros(2, 4, 8, dtype=torch.int32)
    pages = torch.zeros(2, 3, dtype=torch.int32)
    reg = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        t_hl.hmmu_lookup_fused_cuda(table, pages, reg, reg)


# ------------------------------------------- each module's point axis
def _random_points(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return rng, [random_table(cfg, rng) for _ in range(b)]


@pytest.mark.parametrize("policy", POLICIES)
def test_policies_over_a_point_axis_equal_each_point(policy):
    """Each policy over four points (own tables, pointers, chunks and
    params) against its one-point calls, ties included: tables with few
    hotness values make the arg-max and arg-min tie."""
    cfg = tcore.small_platform(policy=policy, hot_threshold=2)
    rng, tabs = _random_points(cfg, 4, 30)
    for t in tabs:
        t[:, 2] = rng.integers(0, 3, cfg.n_pages)
    base = cfg.runtime()
    params = [base._replace(
        n_fast_pages=torch.tensor(6 + i, dtype=torch.int32),
        hot_threshold=torch.tensor(1 + i, dtype=torch.int32),
        wear_slack=torch.tensor(20 * i, dtype=torch.int32)) for i in range(4)]
    pages = rng.integers(-2, cfg.n_pages + 2, (4, 16)).astype(np.int32)
    pages[1] = cfg.n_fast_pages + 2 * np.arange(16)      # a stride
    is_write = rng.random((4, 16)) < 0.4
    valid = rng.random((4, 16)) < 0.9
    ptr = rng.integers(0, 6, 4).astype(np.int32)
    min_wear = torch.tensor([0, 40, 100, 7], dtype=torch.int32)
    fn = t_pol.get(policy)
    kw = lambda i: ({"min_wear": min_wear if i is None else min_wear[i]}  # noqa
                    if policy == "wear_level" else {})
    got = fn(cfg, stacked(params), T(np.stack(tabs)), T(ptr), T(pages),
             T(is_write), T(valid), **kw(None))
    for i in range(4):
        want = fn(cfg, params[i], T(tabs[i]), T(ptr[i]), T(pages[i]),
                  T(is_write[i]), T(valid[i]), **kw(i))
        assert_same(want, tuple(x[i] for x in got), f"{policy} point {i}")


@pytest.mark.parametrize("n_banks", [2, 16])
def test_latency_and_in_order_over_a_point_axis(n_banks):
    rng = np.random.default_rng(n_banks)
    b, n = 3, 40
    arrival = np.sort(rng.integers(0, 5000, (b, n)), -1).astype(np.int32)
    arrival[rng.random((b, n)) < 0.1] = -(2 ** 30)
    service = rng.integers(0, 400, (b, n)).astype(np.int32)
    bank = rng.integers(0, 2 * n_banks, (b, n)).astype(np.int32)
    free = rng.integers(0, 3000, (b, 2 * n_banks)).astype(np.int32)
    last = rng.integers(0, 4000, b).astype(np.int32)
    for fn in (t_lat.resolve_bank_queues, t_lat.resolve_bank_queues_segmented):
        got = fn(T(arrival), T(service), T(bank), 2 * n_banks, T(free))
        for i in range(b):
            assert_same(fn(T(arrival[i]), T(service[i]), T(bank[i]),
                           2 * n_banks, T(free[i])),
                        tuple(x[i] for x in got), f"{fn.__name__} {i}")
    got = t_cons.in_order_returns(T(arrival), T(last))
    p = tcore.small_platform().runtime()
    ps = stacked([p, p._replace(link_bytes_per_cycle=torch.tensor(
        2.5, dtype=torch.float32)), p])
    srv = t_lat.device_service_cycles(ps, T(bank % 2), T(service % 2 == 0),
                                      T(service))
    for i in range(b):
        assert_same(t_cons.in_order_returns(T(arrival[i]), T(last[i])),
                    got[i], f"in order {i}")
        assert_same(t_lat.link_service_cycles(point(ps, i), T(service[i])),
                    t_lat.link_service_cycles(ps, T(service))[i], f"link {i}")
        assert_same(t_lat.device_service_cycles(
            point(ps, i), T(bank[i] % 2), T(service[i] % 2 == 0),
            T(service[i])), srv[i], f"device {i}")


def test_dma_over_a_point_axis_equals_each_point():
    cfg = tcore.small_platform()
    rng, tabs = _random_points(cfg, 3, 40)
    p = cfg.runtime()
    dma = [t_dma.DMAState(*(torch.tensor(int(v), dtype=torch.int32) for v in (
        rng.integers(0, 2), rng.integers(-1, 64), rng.integers(-1, 64),
        rng.integers(0, 500), rng.integers(0, 9)))) for _ in range(3)]
    dma[0] = dma[0]._replace(active=torch.tensor(1, dtype=torch.int32))
    page = rng.integers(0, 64, (3, 24)).astype(np.int32)
    page[:, ::3] = [[int(d.page_a)] for d in dma]
    off = (rng.integers(0, 64, (3, 24)) * 64).astype(np.int32)
    t = rng.integers(0, 3000, (3, 24)).astype(np.int32)
    dev = rng.integers(0, 2, (3, 24)).astype(np.int32)
    frm = rng.integers(0, 50, (3, 24)).astype(np.int32)
    ra = np.stack([tb[3] for tb in tabs])
    rb = np.stack([tb[11] for tb in tabs])
    ra[1, 6] |= t_table.POISONED
    now = T(rng.integers(0, 3000, 3).astype(np.int32))
    rescue = torch.tensor([-1, int(dma[1].page_a), 5], dtype=torch.int32)
    want_ = T(rng.random(3) < 0.8)
    pa = T(rng.integers(0, 64, 3).astype(np.int32))
    pb = T(rng.integers(0, 64, 3).astype(np.int32))
    ps, ds, tab = stacked([p] * 3), stacked(dma), T(np.stack(tabs))
    red = t_dma.redirect(cfg, ds, T(page), T(off), T(t), T(dev), T(frm),
                         T(ra), T(rb), ps)
    plan = t_dma.plan_commit(cfg, ds, now, T(ra), T(rb), ps, rescue)
    comp = t_dma.maybe_complete(cfg, ds, now, tab, ps)
    start = t_dma.maybe_start(ds, want_, pa, pb, now, tab)
    for i in range(3):
        where = f"point {i}"
        assert_same(t_dma.redirect(cfg, dma[i], T(page[i]), T(off[i]),
                                   T(t[i]), T(dev[i]), T(frm[i]), T(ra[i]),
                                   T(rb[i]), p), tuple(x[i] for x in red),
                    f"redirect {where}")
        one = t_dma.plan_commit(cfg, dma[i], now[i], T(ra[i]), T(rb[i]), p,
                                rescue[i])
        assert_same(one, point(plan._replace(
            lanes=plan.lanes.expand(3, -1)), i), f"plan_commit {where}")
        assert_same(t_dma.maybe_complete(cfg, dma[i], now[i], T(tabs[i]), p),
                    tuple(point(x, i) for x in comp),
                    f"maybe_complete {where}")
        assert_same(t_dma.maybe_start(dma[i], want_[i], pa[i], pb[i], now[i],
                                      T(tabs[i])),
                    tuple(point(x, i) for x in start),
                    f"maybe_start {where}")


def test_table_and_indexing_helpers_over_a_point_axis():
    """Each point reads and writes its own table; a dropped scatter update
    lands on the point's own index 0 (as an add of 0)."""
    cfg = tcore.small_platform()
    rng, tabs = _random_points(cfg, 3, 50)
    tab = T(np.stack(tabs))
    idx = T(rng.integers(-70, 70, (3, 9)).astype(np.int32))
    for i in range(3):
        assert_same(t_idx.take(T(tabs[i]), idx[i]),
                    t_idx.take_rows(tab, idx)[i], f"take_rows {i}")
        assert_same(t_idx.take_lane(T(tabs[i]), idx[i], t_table.WEAR),
                    t_idx.take_lane(tab, idx, t_table.WEAR)[i], f"lane {i}")
    pages = T(rng.integers(-3, 64, (3, 4)).astype(np.int32))
    for fn, args in ((t_table.set_flags, (t_table.PIN_SLOW,)),
                     (t_table.clear_flags, ())):
        got = fn(tab, pages, *args)
        for i in range(3):
            assert_same(fn(T(tabs[i]), pages[i], *args), got[i],
                        f"{fn.__name__} {i}")
    shifts = torch.tensor([0, 1, 3], dtype=torch.int32)
    got = t_table.decay_hotness(tab, shifts)
    for i in range(3):
        assert_same(t_table.decay_hotness(T(tabs[i]), int(shifts[i])),
                    got[i], f"decay {i}")
    targets = T(rng.integers(0, 5, (3, 20)).astype(np.int32))
    w = T(rng.integers(0, 5, (3, 20)).astype(np.int32))
    pre = T((t_table.HOTNESS_CAP - rng.integers(0, 12, (3, 20))
             ).astype(np.int32))
    got = t_table.saturating_weights(targets, w, pre, t_table.HOTNESS_CAP)
    for i in range(3):
        assert_same(t_table.saturating_weights(targets[i], w[i], pre[i],
                                               t_table.HOTNESS_CAP),
                    got[i], f"saturating {i}")
    flat = torch.zeros(3, 10, dtype=torch.int32)
    t_idx.scatter_add_drop_(flat, torch.tensor([[1, -1, 10], [12, 0, -11],
                                                [-3, 4, 4]]),
                            torch.tensor([[5, 6, 7], [8, 9, 10],
                                          [11, 12, 13]], dtype=torch.int32))
    want = torch.zeros(3, 10, dtype=torch.int32)
    want[0, 1], want[0, 9] = 5, 6
    want[1, 0] = 9
    want[2, 7], want[2, 4] = 11, 25
    assert torch.equal(flat, want)


def test_counters_and_fault_readers_over_a_point_axis():
    rng = np.random.default_rng(60)
    b, n = 3, 32
    p = tcore.small_platform().runtime()
    ps = stacked([p, p._replace(power_pj_per_bit_slow_write=torch.tensor(
        7.5, dtype=torch.float32)), p])
    dev = T(rng.integers(0, 2, (b, n)).astype(np.int32))
    iw = T(rng.random((b, n)) < 0.4)
    size = T(rng.choice([64, 128, 4096], (b, n)).astype(np.int32))
    valid = T(rng.random((b, n)) < 0.9)
    lat = T(rng.integers(0, 90000, (b, n)).astype(np.int32))
    poi, inj = T(rng.random((b, n)) < 0.1), T(rng.random((b, n)) < 0.1)
    held = torch.tensor([3, 0, 7], dtype=torch.int32)
    ret = torch.tensor([True, False, True])
    zero = t_ctr.Counters.zeros()
    c0 = stacked([zero, zero._replace(energy_pj=torch.tensor(
        1234.5678, dtype=torch.float32)), zero])
    got = t_ctr.update(ps, c0, device=dev, is_write=iw, size=size,
                       valid=valid, latency=lat, held=held, poisoned=poi,
                       retired=ret, injected=inj)
    for i in range(b):
        want = t_ctr.update(point(ps, i), point(c0, i), device=dev[i],
                            is_write=iw[i], size=size[i], valid=valid[i],
                            latency=lat[i], held=held[i], poisoned=poi[i],
                            retired=ret[i], injected=inj[i])
        assert_same(want, point(got, i), f"counters {i}")
    plans = [t_faults.pad_plan(t_faults.seeded_plan(
        i, pages=np.arange(8, 20), n_chunks=4, n_deaths=1 + i,
        n_transient=6), 6, 4) for i in range(b)]
    chunk_idx = torch.tensor([0, 2, 3], dtype=torch.int32)
    cursor = torch.tensor([0, 5, 1], dtype=torch.int32)
    page = T(rng.integers(8, 20, (b, n)).astype(np.int32))
    for plan in (t_faults.stack_plans(plans), plans[1]):
        inj_b = t_faults.injected(plan, page, chunk_idx)
        death_b = t_faults.next_death(plan, cursor)
        for i in range(b):
            one = point(plan, i) if plan.is_batched else plan
            assert_same(t_faults.injected(one, page[i], chunk_idx[i]),
                        inj_b[i], f"injected {i}")
            assert_same(t_faults.next_death(one, cursor[i]), death_b[i],
                        f"next death {i}")


@pytest.mark.parametrize("seed", range(2))
def test_segmented_resolver_out_of_range_banks_match_jax(seed):
    """A corrupt table's bank (negative or past the end) reads
    ``bank_free`` under JAX's gather rule and drops its write, in one
    point and over a point axis: the JAX resolver's results, bit for
    bit, and no index error (on a card, no device-side assert)."""
    from repro.core import latency as j_lat
    rng = np.random.default_rng(70 + seed)
    b, n, nb = 2, 48, 8
    arrival = np.sort(rng.integers(0, 5000, (b, n)), -1).astype(np.int32)
    service = rng.integers(0, 400, (b, n)).astype(np.int32)
    bank = rng.integers(-2 * nb, 2 * nb, (b, n)).astype(np.int32)
    free = rng.integers(0, 3000, (b, nb)).astype(np.int32)
    got = t_lat.resolve_bank_queues_segmented(T(arrival), T(service),
                                              T(bank), nb, T(free))
    for i in range(b):
        want = j_lat.resolve_bank_queues_segmented(
            jnp.asarray(arrival[i]), jnp.asarray(service[i]),
            jnp.asarray(bank[i]), nb, jnp.asarray(free[i]))
        assert_same(want, tuple(x[i] for x in got), f"point {i}")
