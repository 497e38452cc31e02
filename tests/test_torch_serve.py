"""The port's serving front end against ``repro.serve``, bit for bit.

``repro_torch.serve`` (buckets, the KV page map, the pin contracts and the
continuous-batching scheduler), ``Engine.run_stream`` and
``Engine.compile_count`` and the ``serve_mixed`` trace family, each held
against the JAX package on the same inputs (numpy seeds; states carried
across by ``convert.state_from_numpy``). All emulator arithmetic is int32
and the report's floats are computed in numpy from the same integers, so
every comparison is exact: reports, dispatch and trace logs, outputs,
final states and the KV map's arrays.
"""
import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jcore
from repro.core import table as j_table
from repro.serve import (BucketSpec as JBucketSpec,
                         ContinuousBatchingScheduler as JScheduler,
                         PagedKVMap as JPagedKVMap,
                         ServeConfig as JServeConfig,
                         release_pin_pages as j_release,
                         stamp_pin_pages as j_stamp)
from repro.trace import TraceSpec as JTraceSpec, generate as j_generate

import repro_torch
import repro_torch.core as tcore
from repro_torch.core import emulator as t_emu, table as t_table
from repro_torch.serve import (BucketSpec, ContinuousBatchingScheduler,
                               PagedKVMap, ServeConfig, release_pin_pages,
                               stamp_pin_pages)
from repro_torch.trace import generators as t_gen

from test_torch_core import T, assert_same, t_state, to_np

_FIELDS = ("page", "offset", "is_write", "size")


def _platform(**kw):
    """tests/test_serve.py's platform, in both packages."""
    base = dict(n_fast_pages=64, n_slow_pages=448, chunk=32)
    base.update(kw)
    return jcore.small_platform(**base), tcore.small_platform(**base)


def _serve_kw(**kw):
    """tests/test_serve.py's ServeConfig knobs."""
    base = dict(sorted_batch_sizes=(32, 64, 128), max_live_seqs=100,
                max_admit_per_step=32, max_pages_per_seq=6,
                positions_per_page=8, window_pages=2,
                prefill_writes_per_page=2)
    base.update(kw)
    return base


def _workload(n, seed=0, pmax=4):
    rng = np.random.default_rng(seed)
    return rng.integers(1, pmax, n), rng.integers(1, 16, n)


# ------------------------------------------------------------------ buckets
@pytest.mark.parametrize("sizes,chunk", [((32, 64, 256), 32),
                                         ((8,), 8), ((16, 48, 80, 96), 16)])
def test_bucket_spec_selection_matches_jax(sizes, chunk):
    jb, tb = JBucketSpec(sizes, chunk), BucketSpec(sizes, chunk)
    assert (tb.min_size, tb.max_size, tb.sorted_batch_sizes) == \
        (jb.min_size, jb.max_size, jb.sorted_batch_sizes)
    for n in range(0, sizes[-1] + 40):
        assert tb.get_dispatch_size(n) == jb.get_dispatch_size(n), n
        if n <= sizes[-1]:
            assert tb.get_padded_batch_size(n) == jb.get_padded_batch_size(n)
        else:
            with pytest.raises(ValueError, match="exceed the largest"):
                tb.get_padded_batch_size(n)


@pytest.mark.parametrize("sizes,match", [((64, 32), "ascending"),
                                         ((32, 32), "ascending"),
                                         ((48,), "multiple of the pipeline"),
                                         ((0, 32), "multiple of the pipeline"),
                                         ((), "at least one")])
def test_bucket_spec_validation_matches_jax(sizes, match):
    for cls in (JBucketSpec, BucketSpec):
        with pytest.raises(ValueError, match=match):
            cls(sizes, chunk=32)


# ------------------------------------------------------------------ KV map
_KV_ARRAYS = ("page_of", "owner", "owner_idx", "pinned", "dead",
              "last_access")


def _kv_state(kv):
    out = {a: getattr(kv, a).copy() for a in _KV_ARRAYS}
    for d, s in kv._stacks.items():
        out[f"stack{d}"] = s.buf[:s.top].copy()
    out["counts"] = np.array([kv.evictions, kv.retired, kv.free_total,
                              kv.low_mark, kv.high_mark])
    return out


def _assert_kv_equal(jkv, tkv, where):
    a, b = _kv_state(jkv), _kv_state(tkv)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), \
            f"{where}: {k}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_map_ops_match_jax(seed):
    """The same random sequence of alloc / assign / touch / evict /
    release / retire on both maps: every array after every op, and every
    returned value."""
    cfg_j, cfg_t = _platform(n_fast_pages=16, n_slow_pages=48)
    rng = np.random.default_rng(seed)
    args = dict(max_live_seqs=12, max_pages_per_seq=5, pin_pages_per_seq=2,
                free_low_frac=0.3, free_high_frac=0.4)
    jkv, tkv = JPagedKVMap(cfg_j, **args), PagedKVMap(cfg_t, **args)
    fill = np.zeros(12, np.int32)       # pages held by each slot
    for step in range(1, 60):
        op = rng.choice(["alloc", "touch", "evict", "release", "retire"],
                        p=[0.4, 0.2, 0.15, 0.15, 0.1])
        if op == "alloc":
            slots = np.flatnonzero(fill < 5)
            if not len(slots):
                continue
            slots = rng.choice(slots, size=min(3, len(slots)), replace=False)
            k = len(slots)
            if k > jkv.free_total:
                continue
            hint = int(rng.integers(0, 2))
            got = tkv.alloc(k, hint=hint)
            want = jkv.alloc(k, hint=hint)
            assert np.array_equal(got, want) and got.dtype == want.dtype
            idx = fill[slots].copy()
            jkv.assign(slots, idx, want, step)
            tkv.assign(slots, idx, got, step)
            fill[slots] += 1
        elif op == "touch":
            pages = rng.integers(0, cfg_t.n_pages, 4)
            jkv.touch(pages, step)
            tkv.touch(pages, step)
        elif op == "evict":
            prot = rng.integers(0, cfg_t.n_pages, 3).astype(np.int32)
            extra = int(rng.integers(0, 6))
            assert jkv.evictable(step, prot) == tkv.evictable(step, prot)
            got = tkv.maybe_evict(step, extra, protected=prot)
            want = jkv.maybe_evict(step, extra, protected=prot)
            assert np.array_equal(got, want) and got.dtype == want.dtype
        elif op == "release":
            slots = rng.choice(12, size=2, replace=False)
            for x, y in zip(tkv.release_slots(slots),
                            jkv.release_slots(slots)):
                assert np.array_equal(x, y) and x.dtype == y.dtype
            fill[slots] = 0
        else:
            pages = rng.integers(-1, cfg_t.n_pages, 4)
            for x, y in zip(tkv.retire_pages(pages), jkv.retire_pages(pages)):
                assert np.array_equal(x, y) and x.dtype == y.dtype
        _assert_kv_equal(jkv, tkv, f"step {step} ({op})")
    assert jkv.evictions and jkv.retired, "the sequence evicted or retired"


# ------------------------------------------------------------------ contracts
def _contract_state(cfg_j, seed):
    """A fresh state with a swap in flight (a slow page_a, a fast page_b),
    a poisoned page and a retired page."""
    nf, n = cfg_j.n_fast_pages, cfg_j.n_pages
    rng = np.random.default_rng(seed)
    st = repro.Engine(cfg_j).init_state()
    tab = j_table.set_flags(st.table, jnp.array([nf + 5]), j_table.POISONED)
    tab = j_table.set_flags(tab, jnp.array([7]),
                            j_table.POISONED | j_table.RETIRED)
    page_a, page_b = int(rng.integers(nf, n)), int(rng.integers(1, nf))
    st = st._replace(table=tab, dma=st.dma._replace(
        active=jnp.int32(1), page_a=jnp.int32(page_a),
        page_b=jnp.int32(page_b)))
    return st, (page_a, page_b, nf + 5, 7)


def _contract_pages(cfg_j, special, seed, k):
    rng = np.random.default_rng(seed + 100)
    pages = rng.integers(0, cfg_j.n_pages, k).astype(np.int32)
    pages[:len(special)] = special
    pages[-1] = 0                 # a live page 0, as every padding lane
    pages[-2] = cfg_j.n_pages - 1
    return rng.permutation(pages)


@pytest.mark.parametrize("width", [None, 24, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_stamp_and_release_match_jax(seed, width):
    """Stamp then release a batch (padded to ``width``) whose pages hold
    both members of the in-flight swap, a poisoned and a retired page,
    page 0 and the last page: the table bit for bit after each."""
    cfg_j, _ = _platform()
    js, special = _contract_state(cfg_j, seed)
    pages = _contract_pages(cfg_j, special, seed, 20)
    ts = t_state(js)
    js = j_stamp(js, pages, width=width)
    ts = stamp_pin_pages(ts, pages, width=width)
    assert_same(js.table, ts.table, "stamped table")
    flags = ts.table[:, t_table.FLAGS]
    page_a, page_b, poisoned, retired = special
    assert int(flags[page_a]) & t_table.PIN_FAST      # promoted by the swap
    assert int(flags[page_b]) & t_table.PIN_SLOW      # demoted by the swap
    assert not int(flags[poisoned]) & t_table.PINNED
    assert not int(flags[retired]) & t_table.PINNED
    half = pages[:len(pages) // 2]
    js = j_release(js, half, width=width)
    ts = release_pin_pages(ts, half, width=width)
    assert_same(js.table, ts.table, "released table")


def test_stamp_refuses_more_pages_than_the_width():
    _, cfg_t = _platform()
    st = repro_torch.Engine(cfg_t, device="cpu").init_state()
    before = st.table.clone()
    for fn in (stamp_pin_pages, release_pin_pages):
        with pytest.raises(ValueError, match="exceed the pad width"):
            fn(st, [1, 2, 3], width=2)
    assert torch.equal(st.table, before)


# ------------------------------------------------------------------ scheduler
@contextlib.contextmanager
def _count_new_keys(engine):
    """The number of dispatch signatures recorded inside the block (for
    either package's engine)."""
    out = {}
    before = engine.compile_count
    yield out
    out["count"] = engine.compile_count - before


def _run_pair(cfg_kw=None, serve_kw=None, n_seqs=150, seed=0, plan=None,
              forced_evict=False):
    cfg_j, cfg_t = _platform(**(cfg_kw or {}))
    kw = _serve_kw(record_traces=True, **(serve_kw or {}))
    jf = tf = None
    if plan is not None:
        jf = jcore.seeded_plan(**plan)
        tf = tcore.seeded_plan(**plan)
    scheds, recompiles = [], []
    for engine, sched_cls, cfg_cls, faults in (
            (repro.Engine(cfg_j), JScheduler, JServeConfig, jf),
            (repro_torch.Engine(cfg_t, device="cpu"),
             ContinuousBatchingScheduler, ServeConfig, tf)):
        sched = sched_cls(engine, cfg_cls(faults=faults, **kw))
        sched.warmup()
        with _count_new_keys(engine) as cc:
            sched.submit(*_workload(n_seqs, seed))
            if forced_evict:
                for _ in range(3):
                    sched.step()
                victims = sched.kv.maybe_evict(sched._step_no + 1,
                                               extra_needed=1 << 30)
                assert len(victims) and not sched.kv.pinned[victims].any()
            sched.run()
        scheds.append(sched)
        recompiles.append(cc["count"])
    return scheds, recompiles


def _assert_schedulers_equal(js, ts, recompiles):
    a, b = js.report().to_dict(), ts.report().to_dict()
    assert a.pop("compile_count") >= 0 and b.pop("compile_count") >= 0
    assert a == b
    assert recompiles == [0, 0]
    assert js.dispatch_log == ts.dispatch_log
    assert len(js.trace_log) == len(ts.trace_log) == len(js.dispatch_log)
    for i, (jt, tt) in enumerate(zip(js.trace_log, ts.trace_log)):
        assert_same(jt, tt, f"trace_log[{i}]")
    assert len(js.outs_log) == len(ts.outs_log)
    for i, (jo, to) in enumerate(zip(js.outs_log, ts.outs_log)):
        assert set(jo) == set(to)
        for k in jo:
            assert jo[k].dtype == to[k].dtype and \
                np.array_equal(jo[k], to[k]), f"outs_log[{i}][{k}]"
    assert_same(js.carry, ts.carry, "carry")
    _assert_kv_equal(js.kv, ts.kv, "kv")
    assert js.refetches == ts.refetches
    assert js.fault_refetches == ts.fault_refetches


_CASES = {
    "pins": dict(),
    "no_pins": dict(serve_kw=dict(pin_pages_per_seq=0), n_seqs=120),
    "one_in_flight": dict(serve_kw=dict(max_live_batches=1), n_seqs=120),
    "three_in_flight": dict(serve_kw=dict(max_live_batches=3), n_seqs=120),
    "memory_pressure": dict(
        cfg_kw=dict(n_fast_pages=32, n_slow_pages=64),
        serve_kw=dict(max_live_seqs=40, max_admit_per_step=16,
                      free_low_frac=0.2, free_high_frac=0.3),
        n_seqs=80, seed=2),
    "forced_eviction": dict(n_seqs=60, seed=4, forced_evict=True),
    "fault_plan": dict(
        plan=dict(seed=5, pages=np.arange(64), n_chunks=100, n_deaths=12,
                  n_transient=20),
        n_seqs=150, seed=1),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_scheduler_matches_jax(case):
    kw = _CASES[case]
    (js, ts), recompiles = _run_pair(**kw)
    _assert_schedulers_equal(js, ts, recompiles)
    rep = ts.report()
    assert rep.n_sequences == kw.get("n_seqs", 150)
    if case == "fault_plan":
        assert rep.frames_retired > 0 and rep.fault_refetches > 0
    if case in ("memory_pressure",):
        assert rep.evictions > 0
    if case == "forced_eviction":
        assert ts.refetches > 0
    if case == "three_in_flight":
        assert rep.inflight_high_water == 3
    if case == "pins":
        assert rep.pinned_accesses > 0 and rep.renegotiations > 0
        assert not (ts.carry.table[:, t_table.FLAGS]
                    & t_table.PINNED).any(), "a contract outlived its run"
        tcore.check_table(ts.engine.cfg, ts.carry.table)


def test_scheduled_run_equals_its_run_stream_replay():
    """tests/test_serve.py's replay contract on the port: with no pin
    contracts the scheduled run equals ``Engine.run_stream`` over its
    trace log on a fresh engine, at prefetch 0 and 2."""
    _, cfg_t = _platform()
    sched = ContinuousBatchingScheduler(
        repro_torch.Engine(cfg_t, device="cpu"),
        ServeConfig(**_serve_kw(pin_pages_per_seq=0, record_traces=True)))
    sched.warmup()
    sched.submit(*_workload(120))
    sched.run()
    assert any(n < s for s, n in sched.dispatch_log), "no padded drain"
    got = {k: np.concatenate([o[k] for o in sched.outs_log])
           for k in sched.outs_log[0]}
    for prefetch in (0, 2):
        replay = repro_torch.Engine(cfg_t, device="cpu").run_stream(
            iter(sched.trace_log), prefetch=prefetch)
        for k, v in got.items():
            assert np.array_equal(v, replay.outs[k].numpy()), (prefetch, k)
        assert_same(t_emu.clone_state(sched.carry), replay.state, "state")


# ------------------------------------------------------------------ run_stream
def _segments(cfg_j, lengths, seed):
    out = []
    for i, n in enumerate(lengths):
        spec = JTraceSpec(n_requests=n, footprint_pages=cfg_j.n_pages,
                          seed=seed * 31 + i)
        out.append(tuple(np.asarray(x) for x in j_generate(spec))
                   if n else tuple(np.zeros(0, d) for d in
                                   (np.int32, np.int32, bool, np.int32)))
    return out


@pytest.mark.parametrize("lengths", [(40, 96, 23), (5, 0, 7, 64, 3),
                                     (32, 64), (0, 0), ()],
                         ids=["ragged", "sub_chunk", "aligned", "empty_segs",
                              "no_segs"])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_run_stream_matches_jax_and_one_run(lengths, prefetch):
    """Ragged, sub-chunk and empty segments (and an empty stream), with a
    fault plan spanning every dispatch: equal to ``repro``'s run_stream
    and, where there are requests, to one run over the concatenation."""
    cfg_j, cfg_t = _platform(chunk=16)
    segs = _segments(cfg_j, lengths, seed=len(lengths))
    plan = dict(seed=3, pages=np.arange(64), n_chunks=12, n_deaths=3,
                n_transient=6)
    jres = repro.Engine(cfg_j).run_stream(
        iter([jcore.Trace(*map(jnp.asarray, s)) for s in segs]),
        prefetch=prefetch, faults=jcore.seeded_plan(**plan))
    teng = repro_torch.Engine(cfg_t, device="cpu")
    tres = teng.run_stream(iter([tcore.Trace(*map(T, s)) for s in segs]),
                           prefetch=prefetch,
                           faults=tcore.seeded_plan(**plan))
    assert set(jres.outs) == set(tres.outs)
    assert_same(jres.outs, tres.outs, "outs")
    assert_same(jres.state, tres.state, "state")
    if sum(lengths):
        whole = tcore.Trace(*(torch.cat([T(s[i]) for s in segs])
                              for i in range(4)))
        one = teng.run(whole, faults=tcore.seeded_plan(**plan))
        for k in one.outs:
            assert torch.equal(one.outs[k], tres.outs[k]), k
        assert_same(to_np(one.state), tres.state, "one run")


def test_run_stream_donate_false_keeps_the_callers_state():
    cfg_j, cfg_t = _platform(chunk=16)
    segs = _segments(cfg_j, (40, 9, 33), seed=9)
    teng = repro_torch.Engine(cfg_t, device="cpu")
    st = teng.run(tcore.Trace(*map(T, segs[0]))).state
    keep = t_emu.clone_state(st)
    res = teng.run_stream(iter([tcore.Trace(*map(T, s)) for s in segs[1:]]),
                          state=st, donate=False)
    assert_same(to_np(keep), st, "caller's state")
    jeng = repro.Engine(cfg_j)
    jst = jeng.run(jcore.Trace(*map(jnp.asarray, segs[0]))).state
    jres = jeng.run_stream(
        iter([jcore.Trace(*map(jnp.asarray, s)) for s in segs[1:]]),
        state=jst, donate=False)
    assert_same(jres.state, res.state, "continued state")
    assert_same(jres.outs, res.outs, "outs")
    # The default donates the caller's state: updated in place, returned
    # as new objects over the same memory, and consumed.
    res2 = teng.run_stream(iter([tcore.Trace(*map(T, s))
                                 for s in segs[1:]]), state=st)
    assert res2.state is not st
    assert res2.state.table.data_ptr() == st.table.data_ptr()
    assert_same(to_np(res.state), res2.state, "in place")
    with pytest.raises(RuntimeError, match="donate=False"):
        teng.run_stream(iter([tcore.Trace(*map(T, segs[1]))]), state=st)
    with pytest.raises(ValueError, match="donate=True requires state"):
        teng.run_stream(iter([]), donate=True)


# ---------------------------------------------------------- compile_count
def _keys(engine):
    return {k[2:] for k in t_emu._DISPATCH_KEYS if k[0] == engine.static_key}


def test_compile_count_flat_after_warmup_and_raised_by_an_off_bucket_length():
    _, cfg_t = _platform(chunk=16, n_fast_pages=48)   # a geometry of its own
    engine = repro_torch.Engine(cfg_t, device="cpu")
    sched = ContinuousBatchingScheduler(
        engine, ServeConfig(**_serve_kw(sorted_batch_sizes=(32, 64, 128))))
    c0 = engine.compile_count
    sched.warmup()
    assert engine.compile_count == c0 + 3
    sched.submit(*_workload(140, seed=3))
    sched.run()
    assert engine.compile_count == c0 + 3
    assert sched.report().compile_count == c0 + 3
    assert any(n < s for s, n in sched.dispatch_log)
    # A second session of the same geometry shares the keys.
    other = repro_torch.Engine(cfg_t, device="cpu")
    assert other.compile_count == c0 + 3
    z = torch.zeros(48, dtype=torch.int32)
    st = other.run(tcore.Trace(z, z, z.bool(), z + 64),
                   state=other.init_state()).state
    assert engine.compile_count == c0 + 4
    other.run(tcore.Trace(z, z, z.bool(), z + 64), state=st)
    assert engine.compile_count == c0 + 4


def test_dispatch_keys_match_jax():
    """The same calls on both packages record the same (batch, donate,
    shape signature) keys: fresh and carried runs, donate=False, a fault
    plan, padding, run_stream, run_channels, sweep and continue_sweep."""
    cfg_j, cfg_t = _platform(chunk=8, n_fast_pages=40)
    jeng, teng = repro.Engine(cfg_j), repro_torch.Engine(cfg_t, device="cpu")
    from repro.core.emulator import _ENTRY_CACHE
    from repro.sweep import SweepSpec as JSpec
    from repro_torch.sweep import SweepSpec as TSpec
    before, t_before = set(_ENTRY_CACHE), _keys(teng)
    rng = np.random.default_rng(0)
    arrays = (rng.integers(0, 512, 40).astype(np.int32),
              (rng.integers(0, 64, 40) * 64).astype(np.int32),
              rng.random(40) < 0.3, np.full(40, 64, np.int32))
    plan = dict(seed=1, pages=np.arange(40), n_chunks=6, n_deaths=2)
    for eng, Tr, conv, fp, Spec in (
            (jeng, jcore.Trace, jnp.asarray, jcore.seeded_plan, JSpec),
            (teng, tcore.Trace, T, tcore.seeded_plan, TSpec)):
        tr = Tr(*map(conv, arrays))
        st = eng.run(tr).state
        st = eng.run(tr, state=st, faults=fp(**plan)).state
        eng.run(Tr(*(x[:37] for x in tr)), state=st, donate=False)
        eng.run_stream(iter([tr, Tr(*(x[:5] for x in tr))]))
        eng.run_channels(Tr(*(conv(np.stack([x[:32]] * 3))
                              for x in arrays)))
        spec = Spec(base=eng.cfg, policies=("hotness", "static"))
        res = eng.sweep(spec, tr)
        eng.continue_sweep(res, tr, faults=fp(**plan))
    jkeys = {(k[2], k[3], k[4]) for k in set(_ENTRY_CACHE) - before
             if k[0] == jcore.static_key(cfg_j)}
    assert _keys(teng) - t_before == jkeys
    assert len(jkeys) == 7


# ------------------------------------------------------------ serve_mixed
@pytest.mark.parametrize("seed,tenants,window", [(7, 4, 4), (3, 3, 8),
                                                 (11, 1, 2)])
def test_serve_mixed_bounds_determinism_and_frontier(seed, tenants, window):
    spec = t_gen.TraceSpec(n_requests=4096, footprint_pages=250,
                           pattern="serve_mixed", n_tenants=tenants,
                           prefill_frac=0.3, decode_window=window, seed=seed)
    t1, t2 = t_gen.generate(spec), t_gen.generate(spec)
    for a, b in zip(t1, t2):
        assert torch.equal(a, b)                       # deterministic
    page = t1.page.numpy()
    assert page.dtype == np.int32 and t1.is_write.dtype == torch.bool
    assert 0 <= page.min() and page.max() < 250        # in-footprint
    assert 0 < t1.is_write.float().mean() < 1          # mixed traffic
    # The frontier rule, recomputed in numpy from the drawn tenants.
    d = t_gen.serve_draws(spec)
    tenant, pre = d.tenant.numpy(), d.is_prefill.numpy()
    delta, dw = d.delta.numpy(), d.decode_write.numpy()
    per = 250 // tenants
    want = np.empty(4096, np.int64)
    front = np.zeros(tenants, np.int64)
    for i in range(4096):
        t = tenant[i]
        if pre[i]:
            front[t] += 1
            want[i] = t * per + front[t] % per
        else:
            want[i] = t * per + max(front[t] - 1 - delta[i], 0) % per
    assert np.array_equal(page, want)
    assert np.array_equal(t1.is_write.numpy(), pre | (dw & (delta == 0)))
    assert 0 <= delta.min() and delta.max() < window
    assert set(np.unique(tenant)) == set(range(tenants))
    jt = j_generate(JTraceSpec(**dataclasses.asdict(spec)))
    assert np.asarray(jt.page).max() < 250                # the same bounds
