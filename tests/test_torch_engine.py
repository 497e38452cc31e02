"""The slice as a whole: ``repro_torch.Engine(cfg, device="cpu").run``
against ``repro.Engine(cfg).run``, the golden digests, and the
sequential ``chunk=1`` oracle (the port's own ``repro_torch.sims``) —
all bit for bit."""
import numpy as np
import pytest
import torch

import repro
import repro.core as jcore
from repro.core import faults as j_faults

import repro_torch
import repro_torch.core as tcore
from repro_torch.convert import state_to_numpy
from repro_torch.core.emulator import clone_state
from repro_torch.sims import trace_sim

from conftest import make_trace_arrays
from test_endurance import (_GOLDEN, _adversarial_state, _digest_run,
                            _golden_base, _swap_pair_trace)
from test_torch_core import POLICIES, T, assert_same, t_plan, t_state

_STATE_FIELDS = ("table", "clock_ptr", "chunk_idx", "dma", "clock",
                 "bank_free", "link_free_rx", "link_free_tx", "last_return",
                 "counters", "rescue_page", "min_wear", "fault_cursor")


def _t_trace(jt):
    return tcore.Trace(*(T(np.asarray(x)) for x in jt))


def _assert_runs_equal(jres, tres, where):
    for k in jres.outs:
        assert_same(jres.outs[k], tres.outs[k], f"{where} outs[{k}]")
    for f in _STATE_FIELDS:
        assert_same(getattr(jres.state, f), getattr(tres.state, f),
                    f"{where} state.{f}")


def _configs(policy, **kw):
    kw = dict(chunk=8, hot_threshold=2, decay_every=8, policy=policy, **kw)
    return jcore.small_platform(**kw), tcore.small_platform(**kw)


@pytest.mark.parametrize("faults", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_engine_run_matches_jax(policy, faults):
    """Two legs (a fresh run, then a run continued through ``state=``)
    from the adversarial state; with faults, also endurance retirement
    and a plan of deaths and transients. The second trace is ragged, so
    padding and trimming are exercised too."""
    extra = dict(endurance_budget=3) if faults else {}
    cfg_j, cfg_t = _configs(policy, **extra)
    jt = _swap_pair_trace(cfg_j, 96, seed=1)
    jt2 = _swap_pair_trace(cfg_j, 61, seed=2)
    jplan = None
    if faults:
        jplan = j_faults.seeded_plan(3, pages=np.arange(8, 64), n_chunks=20,
                                     n_deaths=3, n_transient=8)
    jeng = repro.Engine(cfg_j)
    teng = repro_torch.Engine(cfg_t, device="cpu")
    js0 = _adversarial_state(cfg_j)
    ts0 = t_state(js0)
    tplan = None if jplan is None else t_plan(jplan)

    jr = jeng.run(jt, state=js0, donate=False, faults=jplan)
    tr = teng.run(_t_trace(jt), state=ts0, donate=False, faults=tplan)
    _assert_runs_equal(jr, tr, "leg 1")
    assert_same(js0, ts0, "donate=False kept the start state")
    jr = jeng.run(jt2, state=jr.state, faults=jplan)
    tr = teng.run(_t_trace(jt2), state=tr.state, faults=tplan)
    _assert_runs_equal(jr, tr, "leg 2")
    assert jr.summary() == tr.summary()
    if faults:
        assert int(tr.state.counters.frames_retired) > 0
        assert int(tr.state.counters.transient_faults) > 0
    tcore.check_table(cfg_t, tr.state.table)


@pytest.mark.parametrize("resolver", ["dense", "segmented"])
@pytest.mark.parametrize("policy", sorted(_GOLDEN))
def test_golden_digests(policy, resolver):
    """The sixteen hex digits of tests/test_endurance.py's _GOLDEN, with
    that file's scenario and hash recipe: a two-leg run from the
    adversarial state."""
    base = _golden_base(policy).with_(bank_resolver=resolver)
    jt = _swap_pair_trace(base, 96)
    cfg_t = tcore.small_platform(chunk=8, hot_threshold=2, decay_every=8,
                                 policy=policy, bank_resolver=resolver)
    eng = repro_torch.Engine(cfg_t, device="cpu")
    res = eng.run(_t_trace(jt), state=t_state(_adversarial_state(base)))
    res = eng.run(_t_trace(jt), state=res.state)
    assert _digest_run(res) == _GOLDEN[policy]


@pytest.mark.parametrize("policy", ["static", "hotness", "write_bias"])
@pytest.mark.parametrize("seed", [0, 1])
def test_chunk1_matches_trace_sim_oracle(policy, seed):
    cfg = tcore.small_platform(chunk=1, policy=policy, hot_threshold=2,
                               decay_every=8, write_weight=2)
    cfg_j = jcore.small_platform(chunk=1, policy=policy, hot_threshold=2,
                                 decay_every=8, write_weight=2)
    arrays = make_trace_arrays(cfg_j, 120, np.random.default_rng(seed))
    state, outs = repro_torch.Engine(cfg, device="cpu").run(
        tcore.Trace(*map(T, arrays)))
    oracle = trace_sim.simulate(cfg, *arrays)
    np.testing.assert_array_equal(outs["returns"].numpy(), oracle.returns)
    np.testing.assert_array_equal(outs["device"].numpy(), oracle.device)
    assert int(state.clock) == oracle.clock
    assert int(state.dma.swaps_done) == oracle.swaps


def test_restricted_registry_and_params_override():
    """A two-policy registry indexes its own ids; params= overrides the
    design point."""
    cfg_j, cfg_t = _configs("wear_level")
    jt = _swap_pair_trace(cfg_j, 64, seed=4)
    names = ("static", "wear_level")
    jr = repro.Engine(cfg_j, registry=names).run(jt)
    teng = repro_torch.Engine(cfg_t, registry=names, device="cpu")
    assert int(teng.params.policy_id) == 1
    _assert_runs_equal(jr, teng.run(_t_trace(jt)), "registry")
    p_static = teng.params._replace(policy_id=torch.tensor(0,
                                                           dtype=torch.int32))
    res = teng.run(_t_trace(jt), params=p_static)
    assert int(res.state.dma.swaps_done) == 0
    with pytest.raises(ValueError, match="registry"):
        _ = repro_torch.Engine(cfg_t, registry=("static",),
                               device="cpu").params


def test_run_updates_state_in_place_unless_donate_false():
    cfg = tcore.small_platform(chunk=8, hot_threshold=2)
    eng = repro_torch.Engine(cfg, device="cpu")
    arrays = make_trace_arrays(cfg, 64, np.random.default_rng(0))
    trace = tcore.Trace(*map(T, arrays))
    s0 = eng.run(trace).state
    keep = clone_state(s0)
    r1 = eng.run(trace, state=s0, donate=False)
    assert_same(state_to_numpy(keep), s0, "donate=False left the state alone")
    r2 = eng.run(trace, state=s0)
    assert r2.state.table.data_ptr() == s0.table.data_ptr()   # in place
    assert torch.equal(r1.state.table, r2.state.table)
    with pytest.raises(ValueError, match="donate=True"):
        eng.run(trace, donate=True)
    with pytest.raises(ValueError, match="chunk-multiple"):
        eng.run(tcore.Trace(*(x[:13] for x in trace)),
                valid=torch.ones(13, dtype=torch.bool))


def test_engine_needs_a_device_or_an_explicit_cpu():
    """No CUDA and no device="cpu": the engine raises rather than moving
    to the CPU quietly; "on" with CPU tensors raises too."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = tcore.small_platform()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.Engine(cfg)
    eng = repro_torch.Engine(cfg.with_(chunk_step_kernel="on"), device="cpu")
    arrays = make_trace_arrays(cfg, 32, np.random.default_rng(0))
    with pytest.raises(ValueError, match="CUDA"):
        eng.run(tcore.Trace(*map(T, arrays)))
