"""The port's design-point sweep against the JAX package's, bit for bit.

``repro_torch.Engine(cfg, device="cpu").sweep`` / ``continue_sweep`` /
``run_channels`` against ``repro.Engine``'s, field by field (every state
tensor, with its leading point axis, and every output), the golden sweep
digests of ``tests/test_endurance.py``, the results table and its files,
and the kernel route's Python: one launch's packing of B points and the
reading back of its stacked outputs, with the launch replaced by its
plain contract (``test_torch_scan.plain_kernel``). Inputs come from numpy
seeds; every comparison is exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jcore
from repro.core import faults as j_faults
from repro.sweep import SweepSpec as JSpec, load_rows as j_load_rows

import repro_torch
import repro_torch.core as tcore
from repro_torch import convert
from repro_torch.core import emulator as t_emu, faults as t_faults
from repro_torch.kernels import chunk_step as tcs
from repro_torch.sweep import (SweepSpec as TSpec, build_points, load_rows,
                               stack_params)

from conftest import make_trace_arrays
from test_endurance import _GOLDEN_SWEEP, _GOLDEN_SWEEP_CONT, _digest_sweep
from test_torch_core import T, assert_same, t_params, t_plan, to_np
from test_torch_scan import _flat, plain_kernel

_BASE = dict(chunk=8, hot_threshold=2, decay_every=8)


def _bases(**kw):
    kw = {**_BASE, **kw}
    return jcore.small_platform(**kw), tcore.small_platform(**kw)


def _traces(cfg_j, n, seed, hot_fraction=0.3):
    arrays = make_trace_arrays(cfg_j, n, np.random.default_rng(seed),
                               hot_fraction=hot_fraction)
    return (jcore.Trace(*map(jnp.asarray, arrays)),
            tcore.Trace(*map(T, arrays)))


def _specs(bases, **axes):
    return JSpec(base=bases[0], **axes), TSpec(base=bases[1], **axes)


def _assert_sweeps_equal(jres, tres, where):
    assert_same(jres.states, tres.states, f"{where} states")
    assert jres.outs.keys() == tres.outs.keys()
    assert_same(jres.outs, tres.outs, f"{where} outs")


def _j_state(d):
    """A numpy dict from ``convert.state_to_numpy`` -> a JAX state."""
    def build(cls, v):
        return cls(**{k: jnp.asarray(x) for k, x in v.items()})
    return jcore.EmulatorState(**{
        k: build(jcore.dma.DMAState, v) if k == "dma"
        else build(jcore.counters.Counters, v) if k == "counters"
        else jnp.asarray(v) for k, v in d.items()})


def _plans(cfg_j, n_points, n_chunks):
    """One seeded plan a point, padded to one shape: (JAX stacked, port
    stacked)."""
    plans = [j_faults.pad_plan(j_faults.seeded_plan(
        i, pages=np.arange(cfg_j.n_fast_pages, cfg_j.n_pages),
        n_chunks=n_chunks, n_deaths=i % 3, n_transient=2 + i % 5), 8, 4)
        for i in range(n_points)]
    jplan = j_faults.stack_plans(plans)
    tplan = t_faults.stack_plans([t_plan(p) for p in plans])
    return jplan, tplan


# ------------------------------------------------------------ the goldens
def test_golden_sweep_digests():
    """``_GOLDEN_SWEEP`` / ``_GOLDEN_SWEEP_CONT`` with
    ``test_disabled_sweep_matches_golden``'s scenario and hash recipe."""
    cfg_j, base = _bases()
    spec = TSpec(base=base, technologies=("3dxpoint", "stt-ram"),
                 fast_fractions=(0.125,), policies=("hotness", "static"),
                 link_lats=(40,))
    rng = np.random.default_rng(11)
    t = tcore.Trace(*map(T, make_trace_arrays(cfg_j, 128, rng,
                                              hot_fraction=0.3)))
    engine = repro_torch.Engine(base, device="cpu")
    result = engine.sweep(spec, t)
    assert _digest_sweep(result) == _GOLDEN_SWEEP
    cont = engine.continue_sweep(result, t, donate=False)
    assert _digest_sweep(cont) == _GOLDEN_SWEEP_CONT


# --------------------------------------------- the sweep against JAX's
def test_grid_points_and_params_match_jax():
    """``build_points`` (axis order, coordinates, labels, configs),
    ``DesignPoint.params`` and ``stack_params`` against the JAX
    package's."""
    bases = _bases()
    jspec, tspec = _specs(
        bases, technologies=("flash", "stt-ram"),
        fast_fractions=(1 / 9, 0.3), policies=("wear_level", "static"),
        link_lats=(40, 600), extra_axes=(("hot_threshold", (2, 5)),))
    jpts, tpts = jspec.build(), build_points(tspec)
    assert [p.label for p in jpts] == [p.label for p in tpts]
    assert [p.coords for p in jpts] == [p.coords for p in tpts]
    assert [p.index for p in jpts] == [p.index for p in tpts] == \
        list(range(32))
    for jp, tp in zip(jpts, tpts):
        assert dataclasses.asdict(jp.cfg) == dataclasses.asdict(tp.cfg)
        assert_same(jp.params, tp.params(), tp.label)
    assert_same(repro.engine.stack_params(jpts), stack_params(tpts),
                "stack_params")


@pytest.mark.parametrize("case", ["grid", "shared_plan", "stacked_plan",
                                  "prestacked"])
def test_sweep_matches_jax(case):
    """The port's sweep against ``repro.Engine.sweep`` field by field:
    a grid whose policy subset is not in built-in order, with fast
    fractions and ``extra_axes``; a shared and a stacked per-point fault
    plan under endurance retirement; a pre-stacked ``RuntimeParams``
    batch over a restricted registry with a ``policy_id`` past its end
    (the clamped policy, ``write_bias``, with no write weighting) beside
    the same point at ``write_bias``'s own id."""
    cfg_j, cfg_t = _bases(write_weight=3,
                          endurance_budget=0 if case == "grid" else 3)
    jt, tt = _traces(cfg_j, 93, seed=5)
    n_chunks = -(-93 // cfg_j.chunk)
    kw, jkw, tkw = {}, {}, {}
    if case == "grid":
        axes = dict(policies=("wear_level", "static", "hotness"),
                    fast_fractions=(0.125, 0.25),
                    extra_axes=(("pin_fast_fraction", (0.0, 0.25)),
                                ("endurance_budget", (0, 3)),
                                ("wear_slack", (4,))))
    else:
        axes = dict(technologies=("3dxpoint", "flash"),
                    policies=("hotness_global", "write_bias", "stream"),
                    link_lats=(40, 900))
    jspec, tspec = _specs((cfg_j, cfg_t), **axes)
    if case == "shared_plan":
        plan = j_faults.seeded_plan(2, pages=np.arange(8, 64),
                                    n_chunks=n_chunks, n_deaths=3,
                                    n_transient=6)
        jkw, tkw = dict(faults=plan), dict(faults=t_plan(plan))
    elif case == "stacked_plan":
        jplan, tplan = _plans(cfg_j, 12, n_chunks)
        jkw, tkw = dict(faults=jplan), dict(faults=tplan)
    elif case == "prestacked":
        names = ("static", "hotness", "write_bias")
        kw = dict(registry=names)
        pts = jspec.build()[:3]
        jparams = repro.engine.stack_params(pts + pts[2:])._replace(
            policy_id=jnp.asarray([0, 2, 9, 2], jnp.int32))
        jspec, tspec = jparams, t_params(jparams)
    jres = repro.Engine(cfg_j, **kw).sweep(jspec, jt, **jkw)
    tres = repro_torch.Engine(cfg_t, device="cpu", **kw).sweep(
        tspec, tt, **tkw)
    _assert_sweeps_equal(jres, tres, case)
    assert tres.registry.names == jres.registry.names
    assert [p.label for p in tres.points] == [p.label for p in jres.points]
    assert tres.outs["returns"].shape == (len(tres), n_chunks * 8)
    if case != "grid":
        assert int(tres.states.counters.frames_retired.sum()) > 0
    if case.endswith("plan"):
        assert int(tres.states.counters.transient_faults.sum()) > 0
    if case == "prestacked":   # write_bias, with and without its weighting
        assert not torch.equal(tres.states.table[2], tres.states.table[3])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_continuation_across_packages(direction):
    """A sweep of the first half in one package, its stacked states
    carried across by ``convert``, continued over the second half in the
    other: equal to the second package's own continuation."""
    cfg_j, cfg_t = _bases(endurance_budget=3)
    jspec, tspec = _specs((cfg_j, cfg_t), technologies=("3dxpoint", "mram"),
                          policies=("stream", "hotness"),
                          fast_fractions=(0.125, 0.5))
    jt, tt = _traces(cfg_j, 80, seed=7)
    jt2, tt2 = _traces(cfg_j, 61, seed=8)
    jeng = repro.Engine(cfg_j)
    teng = repro_torch.Engine(cfg_t, device="cpu")
    jres = jeng.sweep(jspec, jt)
    tres = teng.sweep(tspec, tt)
    _assert_sweeps_equal(jres, tres, "first half")
    if direction == "jax_to_port":
        carried = dataclasses.replace(
            tres, states=convert.state_from_numpy(to_np(jres.states)))
        got = teng.continue_sweep(carried, tt2)
        want = jeng.continue_sweep(jres, jt2, donate=False)
        assert got.states.table.data_ptr() == \
            carried.states.table.data_ptr()
        with pytest.raises(RuntimeError, match="consumed"):
            teng.continue_sweep(carried, tt2)
    else:
        carried = dataclasses.replace(
            jres, states=_j_state(convert.state_to_numpy(tres.states)))
        got = teng.continue_sweep(tres, tt2, donate=False)
        want = jeng.continue_sweep(carried, jt2)
    _assert_sweeps_equal(want, got, direction)


def test_stacked_fields_cross_over_both_ways():
    """Stacked params, states and plans (leading point axis) cross from
    JAX into the port and back with shapes and bytes kept."""
    cfg_j, _ = _bases()
    pts = JSpec(base=cfg_j, policies=("static", "hotness"),
                fast_fractions=(0.125, 0.25)).build()
    jparams = repro.engine.stack_params(pts)
    jstates = repro.Engine(cfg_j).sweep(pts, _traces(cfg_j, 16, 0)[0]).states
    jplan, tplan = _plans(cfg_j, 4, 3)
    for jx, to_port, back in (
            (jparams, convert.params_from_numpy, convert.params_to_numpy),
            (jstates, convert.state_from_numpy, convert.state_to_numpy),
            (jplan, convert.faults_from_numpy, convert.faults_to_numpy)):
        tx = to_port(to_np(jx))
        assert_same(jx, tx)
        assert_same(jx, back(tx))
    assert tplan.is_batched and tplan.shape_sig == ((4, 8, 2), (4, 4, 2))
    assert not tcore.FaultPlan.empty().is_batched


def test_stack_plans_rejects_mixed_shapes():
    a = t_faults.seeded_plan(0, pages=np.arange(8), n_chunks=4,
                             n_transient=2)
    with pytest.raises(ValueError, match="disagree"):
        t_faults.stack_plans([a, tcore.FaultPlan.empty()])


# ------------------------------------------------------ results table
def test_rows_and_files_match_jax(tmp_path):
    cfg_j, cfg_t = _bases()
    jspec, tspec = _specs((cfg_j, cfg_t), technologies=("3dxpoint", "flash"),
                          policies=("static", "hotness"), link_lats=(40,))
    jt, tt = _traces(cfg_j, 64, seed=3)
    jres = repro.Engine(cfg_j).sweep(jspec, jt)
    tres = repro_torch.Engine(cfg_t, device="cpu").sweep(tspec, tt)
    rows = tres.rows()
    assert rows == jres.rows()
    assert tres.best() == jres.best()
    assert tres.best("swaps") == jres.best("swaps")
    assert tres.table() == jres.table()
    assert load_rows(tres.to_jsonl(tmp_path / "t.jsonl")) == rows
    assert load_rows(tres.to_csv(tmp_path / "t.csv")) == \
        j_load_rows(jres.to_csv(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == \
        (tmp_path / "j.csv").read_text()


# ----------------------------------------------------------- channels
def test_run_channels_matches_jax():
    """Three channels, each its own trace, one design point and a shared
    plan: states and outputs with the channel axis leading."""
    cfg_j, cfg_t = _bases(policy="wear_level", endurance_budget=3)
    arrays = [make_trace_arrays(cfg_j, 48, np.random.default_rng(s))
              for s in range(3)]
    stacked = [np.stack(xs) for xs in zip(*arrays)]
    plan = j_faults.seeded_plan(4, pages=np.arange(8, 64), n_chunks=6,
                                n_deaths=2, n_transient=4)
    jstates, jouts = repro.Engine(cfg_j).run_channels(
        jcore.Trace(*map(jnp.asarray, stacked)), faults=plan)
    tstates, touts = repro_torch.Engine(cfg_t, device="cpu").run_channels(
        tcore.Trace(*map(T, stacked)), faults=t_plan(plan))
    assert_same(jstates, tstates, "channel states")
    assert_same(jouts, touts, "channel outs")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        repro_torch.Engine(cfg_t, device="cpu").run_channels(
            tcore.Trace(*(T(x[:, :13]) for x in stacked)))


# -------------------------------------------------- errors, in place
def test_sweep_errors():
    cfg_j, cfg_t = _bases()
    _, tt = _traces(cfg_j, 16, seed=0)
    eng = repro_torch.Engine(cfg_t, device="cpu")
    with pytest.raises(ValueError, match="empty sweep"):
        eng.sweep([], tt)
    with pytest.raises(ValueError, match="runtime-sweepable"):
        eng.sweep(TSpec(base=cfg_t, extra_axes=(("chunk", (8, 16)),)), tt)
    other = TSpec(base=cfg_t.with_(chunk=16), policies=("static",)).build()
    with pytest.raises(ValueError, match="static geometry"):
        eng.sweep(other, tt)
    spec = TSpec(base=cfg_t, policies=("static", "hotness"))
    with pytest.raises(ValueError, match="donate=True requires states"):
        eng.sweep(spec, tt, donate=True)
    # mesh= splits the point axis (tests/test_torch_sweep_mesh.py): "auto"
    # runs, equal to no mesh; a mesh that is not a sequence of devices
    # raises, for a sweep and a continuation alike.
    whole = eng.sweep(spec, tt)
    _assert_port_equal(eng.sweep(spec, tt, mesh="auto"), whole)
    for mesh, error in ((object(), TypeError), ((), ValueError)):
        with pytest.raises(error, match="mesh"):
            eng.sweep(spec, tt, mesh=mesh)
        with pytest.raises(error, match="mesh"):
            eng.continue_sweep(eng.sweep(spec, tt), tt, mesh=mesh)


def _assert_port_equal(got, want):
    for a, b in zip(_flat(got.states), _flat(want.states), strict=True):
        assert torch.equal(a, b)
    assert got.outs.keys() == want.outs.keys()
    for k in want.outs:
        assert torch.equal(got.outs[k], want.outs[k]), k


def test_continued_sweep_updates_the_states_in_place_unless_donate_false():
    _, cfg_t = _bases()
    cfg_j = _bases()[0]
    _, tt = _traces(cfg_j, 40, seed=2)
    eng = repro_torch.Engine(cfg_t, device="cpu")
    spec = TSpec(base=cfg_t, policies=("hotness", "wear_level"),
                 link_lats=(40, 80))
    first = eng.sweep(spec, tt)
    keep = t_emu.clone_state(first.states)
    ptrs = [t.data_ptr() for t in _flat(first.states)]
    kept = eng.continue_sweep(first, tt, donate=False)
    for a, b in zip(_flat(first.states), _flat(keep)):
        assert torch.equal(a, b)
    moved = eng.continue_sweep(first, tt)
    assert [t.data_ptr() for t in _flat(moved.states)] == ptrs
    for a, b in zip(_flat(moved.states), _flat(kept.states)):
        assert torch.equal(a, b)
    assert not torch.equal(first.states.clock, keep.clock)


# ------------------------------------------------ the kernel route's Python
@pytest.mark.parametrize("case", ["sweep", "stacked_plan", "continued",
                                  "channels"])
def test_one_launch_route_matches_the_point_loop(case, monkeypatch):
    """The kernel route with its launch replaced by ``plain_kernel`` (B
    points' packed scalars, counters, request vectors and plans in, the
    stacked state and [B, N] outputs read back from its ``KernelOut``):
    ONE call for every point, equal to the loop over the points, and the
    passed stacked state updated in its own tensors."""
    cfg_j, cfg_t = _bases(endurance_budget=3, write_weight=2)
    jt, tt = _traces(cfg_j, 77, seed=9)
    spec = TSpec(base=cfg_t, policies=("write_bias", "hotness_global"),
                 fast_fractions=(0.125, 0.375), link_lats=(40, 300))
    eng = repro_torch.Engine(cfg_t, device="cpu")
    n_chunks = -(-77 // cfg_t.chunk)
    faults = None
    if case == "stacked_plan":
        faults = _plans(cfg_j, 8, n_chunks)[1]
    elif case in ("continued", "channels"):
        faults = t_faults.seeded_plan(6, pages=np.arange(8, 64),
                                      n_chunks=2 * n_chunks, n_deaths=2,
                                      n_transient=5)

    def go():
        if case == "channels":
            arrays = [make_trace_arrays(cfg_j, 40, np.random.default_rng(s))
                      for s in range(4)]
            traces = tcore.Trace(*(T(np.stack(x)) for x in zip(*arrays)))
            return eng.run_channels(traces, faults=faults)
        res = eng.sweep(spec, tt, faults=faults)
        if case == "continued":
            start = t_emu.clone_state(res.states)
            ptrs = [t.data_ptr() for t in _flat(res.states)]
            res = eng.continue_sweep(res, tt, faults=faults)
            assert [t.data_ptr() for t in _flat(res.states)] == ptrs
            assert not torch.equal(start.clock, res.states.clock)
        return res.states, res.outs

    want = go()
    calls = []

    def one_launch(*args, **kw):
        calls.append(args[2].shape[0])
        return plain_kernel(*args, **kw)
    monkeypatch.setattr(tcs, "chunk_step_cuda", one_launch)
    monkeypatch.setattr(tcs, "use_chunk_step_kernel", lambda c, t: True)
    got = go()
    assert calls == ([4] if case == "channels" else
                     [8, 8] if case == "continued" else [8])
    assert got[1].keys() == want[1].keys()
    for a, b in zip(_flat(got), _flat(want), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
