"""The port's software-simulator baselines (``repro_torch.sims``) against
the JAX package's (``repro.sims``) on the same numpy inputs, bit for bit:
every return, latency and device, the final clock, the swaps and every
counter, for ``static``, ``hotness`` and ``write_bias``, ``cycle_sim``
with refresh and with the CPU model on and off, on ``small_platform``
and on the paper's geometry."""
import numpy as np
import pytest

import repro.core as jcore
from repro.core import dma as j_dma
from repro.sims import cycle_sim as j_cycle, trace_sim as j_trace
from repro.trace import workload_trace as j_workload_trace

import repro_torch.core as tcore
from repro_torch.sims import cycle_sim as t_cycle, trace_sim as t_trace

from conftest import make_trace_arrays

POLICIES = ("static", "hotness", "write_bias")
_SMALL = dict(chunk=1, hot_threshold=2, decay_every=8, write_weight=2)


def _configs(policy, **kw):
    return (jcore.small_platform(policy=policy, **{**_SMALL, **kw}),
            tcore.small_platform(policy=policy, **{**_SMALL, **kw}))


def assert_same_result(got, want, where=""):
    for k in ("returns", "latency", "device"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{where} {k}"
    assert got.clock == want.clock, where
    assert got.swaps == want.swaps, where
    assert got.counters == want.counters, where
    # floats compared as bits (== already holds; this names a NaN too)
    for k, v in want.counters.items():
        assert type(got.counters[k]) is type(v), f"{where} {k}"


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_trace_sim_matches_jax(policy, seed):
    cfg_j, cfg_t = _configs(policy)
    arrays = make_trace_arrays(cfg_j, 300, np.random.default_rng(seed))
    want = j_trace.simulate(cfg_j, *arrays)
    assert_same_result(t_trace.simulate(cfg_t, *arrays), want, policy)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("cpu_model", [False, True])
def test_cycle_sim_matches_jax(policy, refresh, cpu_model):
    cfg_j, cfg_t = _configs(policy)
    arrays = make_trace_arrays(cfg_j, 250, np.random.default_rng(5))
    kw = dict(refresh=refresh, cpu_model=cpu_model, tREFI=900, tRFC=120)
    want = j_cycle.simulate(cfg_j, *arrays, **kw)
    assert_same_result(t_cycle.simulate(cfg_t, *arrays, **kw), want,
                       f"{policy} refresh={refresh} cpu_model={cpu_model}")


@pytest.mark.parametrize("policy", POLICIES)
def test_sims_agree_with_each_other_without_refresh(policy):
    """With refresh off, the event-driven simulator keeps the sequential
    one's timing; it may lead by the one swap in flight at the end."""
    _, cfg_t = _configs(policy)
    arrays = make_trace_arrays(cfg_t, 400, np.random.default_rng(2),
                               hot_fraction=0.6)
    r1 = t_trace.simulate(cfg_t, *arrays)
    r2 = t_cycle.simulate(cfg_t, *arrays)
    for k in ("returns", "latency", "device"):
        assert np.array_equal(getattr(r1, k), getattr(r2, k)), k
    assert r1.clock == r2.clock
    assert r2.swaps - r1.swaps in (0, 1)
    if policy != "static":
        assert r1.swaps > 0, "the trace must exercise the DMA path"


@pytest.mark.parametrize("cfg_kw", [
    {}, dict(subblock=256), dict(dma_bytes_per_cycle=3.0),
    dict(page_size=8192, dma_bytes_per_cycle=64.0)])
def test_dma_helpers_match_jax(cfg_kw):
    """The port's sims keep host-int DMA helpers of their own; they equal
    the JAX package's ``dma`` helpers called with ``cfg`` alone."""
    cfg_j = jcore.paper_platform().with_(**cfg_kw)
    cfg_t = tcore.paper_platform().with_(**cfg_kw)
    assert (t_trace.exchange_cycles_per_subblock(cfg_t)
            == j_dma.exchange_cycles_per_subblock(cfg_j))
    assert t_trace.swap_duration(cfg_t) == j_dma.swap_duration(cfg_j)
    assert isinstance(t_trace.swap_duration(cfg_t), int)


@pytest.mark.parametrize("sim", ["trace_sim", "cycle_sim"])
def test_unmodelled_policy_raises(sim):
    _, cfg_t = _configs("wear_level")
    arrays = make_trace_arrays(cfg_t, 8, np.random.default_rng(0))
    mod = {"trace_sim": t_trace, "cycle_sim": t_cycle}[sim]
    with pytest.raises(NotImplementedError):
        mod.simulate(cfg_t, *arrays)


@pytest.mark.parametrize("sim", ["trace_sim", "cycle_sim"])
def test_paper_geometry_migrating_case_matches_jax(sim):
    """The paper's geometry (294,912 pages, 16 banks, 3D XPoint) on the
    first 2,000 requests of ``505.mcf`` under ``write_bias`` at the
    settings the card's chunk-1 oracle runs, which migrate."""
    kw = dict(chunk=1, policy="write_bias", hot_threshold=4,
              decay_every=64, write_weight=4)
    cfg_j = jcore.paper_platform().with_(**kw)
    cfg_t = tcore.paper_platform().with_(**kw)
    trace, _, _ = j_workload_trace("505.mcf", scale=6e-9,
                                   min_requests=2_000)
    arrays = [np.asarray(x)[:2_000] for x in trace]
    if sim == "trace_sim":
        want = j_trace.simulate(cfg_j, *arrays)
        got = t_trace.simulate(cfg_t, *arrays)
    else:
        want = j_cycle.simulate(cfg_j, *arrays, refresh=True,
                                cpu_model=True)
        got = t_cycle.simulate(cfg_t, *arrays, refresh=True, cpu_model=True)
    assert_same_result(got, want, sim)
    assert got.swaps > 0
