"""The split sweep (``Engine.sweep`` / ``continue_sweep`` with ``mesh=``) on
the CPU, bit for bit.

The point axis split over 2, 3 and 4 shares of the CPU (3 points on 2
shares and 6 on 4 pad the count by repeating the last point) against the
port's unsplit sweep, ``repro.Engine.sweep`` under ``jit`` (unsharded: the
JAX package's own sharded sweep cannot run with this JAX), the golden
digests ``_GOLDEN_SWEEP`` / ``_GOLDEN_SWEEP_CONT``; a split, donated
continuation equal to the long run (``tests/test_engine.py``'s
composition test); stacked fault plans split with their points; and the
refusals of a mesh that is not a sequence of the engine's devices.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jcore
from repro.sweep import SweepSpec as JSpec

import repro_torch
import repro_torch.core as tcore
import repro_torch.sweep
from repro_torch.engine import sweep_mesh
from repro_torch.sweep import SweepSpec as TSpec, build_points

from conftest import make_trace_arrays
from test_endurance import _GOLDEN_SWEEP, _GOLDEN_SWEEP_CONT, _digest_sweep
from test_torch_core import T, assert_same
from test_torch_scan import _flat
from test_torch_sweep import _plans

CPU = torch.device("cpu")
_BASE = dict(chunk=8, hot_threshold=2, decay_every=8)


def _traces(cfg_j, n, seed, hot_fraction=0.3):
    arrays = make_trace_arrays(cfg_j, n, np.random.default_rng(seed),
                               hot_fraction=hot_fraction)
    return (jcore.Trace(*map(jnp.asarray, arrays)),
            tcore.Trace(*map(T, arrays)))


def _assert_equal(got, want, where):
    for a, b in zip(_flat(got.states), _flat(want.states), strict=True):
        assert torch.equal(a, b), where
    assert got.outs.keys() == want.outs.keys()
    for k in want.outs:
        assert torch.equal(got.outs[k], want.outs[k]), f"{where} {k}"


# 3 points on 2 shares, 6 on 4 and 4 on 3 pad; 6 on 2 and 6 on 3 divide.
CASES = [(3, 2), (6, 4), (4, 3), (6, 2), (6, 3)]


def _grid(base, n_points):
    spec = TSpec(base=base, policies=("static", "hotness", "wear_level"),
                 link_lats=(40, 80))
    return build_points(spec)[:n_points]


@pytest.mark.parametrize("n_points,shares", CASES)
def test_split_sweep_matches_unsplit_and_jax(n_points, shares):
    """Each split equal to the port's one-device sweep, to JAX's sweep of
    the same points under ``jit``, and the split continuation to the
    unsplit one."""
    cfg_j = jcore.small_platform(**_BASE)
    base = tcore.small_platform(**_BASE)
    jt, tt = _traces(cfg_j, 72, seed=n_points + shares)
    points = _grid(base, n_points)
    jpoints = JSpec(base=cfg_j, policies=("static", "hotness", "wear_level"),
                    link_lats=(40, 80)).build()[:n_points]
    eng = repro_torch.Engine(base, device="cpu")
    mesh = (CPU,) * shares
    whole = eng.sweep(points, tt)
    split = eng.sweep(points, tt, mesh=mesh)
    _assert_equal(split, whole, f"{n_points} points on {shares}")
    jres = repro.Engine(cfg_j).sweep(jpoints, jt)
    assert_same(jres.states, split.states, "states")
    assert_same(jres.outs, split.outs, "outs")
    cont_whole = eng.continue_sweep(whole, tt)
    cont_split = eng.continue_sweep(split, tt, mesh=mesh)
    _assert_equal(cont_split, cont_whole, "continued")


@pytest.mark.parametrize("shares", [2, 3, 4])
def test_split_sweep_matches_the_goldens(shares):
    """``test_disabled_sweep_matches_golden``'s scenario (4 points) on 2,
    3 (padded to 6) and 4 shares: the golden digests, continuation
    included."""
    cfg_j = jcore.small_platform(**_BASE)
    base = tcore.small_platform(**_BASE)
    spec = TSpec(base=base, technologies=("3dxpoint", "stt-ram"),
                 fast_fractions=(0.125,), policies=("hotness", "static"),
                 link_lats=(40,))
    rng = np.random.default_rng(11)
    t = tcore.Trace(*map(T, make_trace_arrays(cfg_j, 128, rng,
                                              hot_fraction=0.3)))
    eng = repro_torch.Engine(base, device="cpu")
    mesh = [CPU] * shares
    result = eng.sweep(spec, t, mesh=mesh)
    assert _digest_sweep(result) == _GOLDEN_SWEEP
    cont = eng.continue_sweep(result, t, donate=False, mesh=mesh)
    assert _digest_sweep(cont) == _GOLDEN_SWEEP_CONT


def test_split_donated_continued_sweep_matches_long_run():
    """The port's ``test_mesh_sharded_donated_continued_sweep_matches_
    long_run``: 6 points (no multiple of 4) on the 4-share mesh, a sweep
    and its donated split continuation equal to one long unsplit sweep;
    the passed states are consumed."""
    cfg_j = jcore.small_platform(chunk=16, hot_threshold=2, decay_every=8)
    base = tcore.small_platform(chunk=16, hot_threshold=2, decay_every=8)
    points = build_points(TSpec(
        base=base, technologies=("3dxpoint", "stt-ram", "mram"),
        policies=("static", "hotness")))
    _, t = _traces(cfg_j, 96, seed=0, hot_fraction=0.5)
    n = len(t)
    t2 = tcore.Trace(*(torch.cat([x, x]) for x in t))
    eng = repro_torch.Engine(base, device="cpu")
    full = eng.sweep(points, t2)
    mesh = (CPU,) * 4
    first = eng.sweep(points, t, mesh=mesh)
    cont = eng.continue_sweep(first, t, mesh=mesh)          # donated
    assert torch.equal(cont.outs["returns"], full.outs["returns"][:, n:])
    for a, b in zip(_flat(cont.states), _flat(full.states), strict=True):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="consumed"):
        eng.continue_sweep(first, t, mesh=mesh)


def test_split_sweep_with_a_stacked_fault_plan():
    """A stacked per-point plan (endurance retirement on) is padded and
    split with its points: 5 points on 3 shares equal to the unsplit
    sweep and to JAX's."""
    kw = dict(_BASE, endurance_budget=3)
    cfg_j = jcore.small_platform(**kw)
    base = tcore.small_platform(**kw)
    jt, tt = _traces(cfg_j, 96, seed=5, hot_fraction=0.6)
    points = _grid(base, 5)
    jpoints = JSpec(base=cfg_j, policies=("static", "hotness", "wear_level"),
                    link_lats=(40, 80)).build()[:5]
    jplan, tplan = _plans(cfg_j, 5, 12)
    eng = repro_torch.Engine(base, device="cpu")
    whole = eng.sweep(points, tt, faults=tplan)
    split = eng.sweep(points, tt, faults=tplan, mesh=(CPU,) * 3)
    _assert_equal(split, whole, "stacked plan")
    jres = repro.Engine(cfg_j).sweep(jpoints, jt, faults=jplan)
    assert_same(jres.states, split.states, "states")


def test_sweep_mesh_and_auto():
    """``sweep_mesh`` of a CPU engine is the one CPU; ``mesh="auto"`` runs
    on it. Without a card, the default (CUDA) mesh raises as an engine
    without ``device="cpu"`` does."""
    assert sweep_mesh("cpu") == (CPU,)
    assert repro_torch.sweep.sweep_mesh is sweep_mesh      # re-exported
    base = tcore.small_platform(**_BASE)
    _, tt = _traces(jcore.small_platform(**_BASE), 40, seed=1)
    eng = repro_torch.Engine(base, device="cpu")
    points = _grid(base, 3)
    _assert_equal(eng.sweep(points, tt, mesh="auto"), eng.sweep(points, tt),
                  "auto")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep_mesh()


@pytest.mark.parametrize("mesh,error,pattern", [
    (object(), TypeError, "sequence of devices"),
    (CPU, TypeError, "sequence of devices"),
    ((), ValueError, "empty mesh"),
    ([], ValueError, "empty mesh"),
    ("all", ValueError, "only 'auto'"),
    ((torch.device("cuda", 0),), ValueError, "engine's type"),
    ((CPU, "cuda"), ValueError, "engine's type"),
])
def test_mesh_refusals(mesh, error, pattern):
    """A mesh that is not a non-empty sequence of the engine's devices
    raises, for a sweep and a continuation; a CUDA mesh on a CPU engine
    too (the reverse is held on the card)."""
    base = tcore.small_platform(**_BASE)
    _, tt = _traces(jcore.small_platform(**_BASE), 16, seed=0)
    eng = repro_torch.Engine(base, device="cpu")
    points = _grid(base, 2)
    with pytest.raises(error, match=pattern):
        eng.sweep(points, tt, mesh=mesh)
    first = eng.sweep(points, tt)
    with pytest.raises(error, match=pattern):
        eng.continue_sweep(first, tt, mesh=mesh)
    # a refused continuation consumes nothing
    eng.continue_sweep(first, tt)
