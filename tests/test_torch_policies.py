"""User-registered policies, the frozen registry, consumed states and the
energy counter's rounding, in the port against the JAX package.

* Energy: the port's ``counters.update`` against ``jax.jit`` of the JAX
  package's (XLA fuses the energy into two FMAs) and against that
  formula written out with exact fractions, on 3,000 random chunks at
  two coefficient sets; and an ``Engine`` sweep long enough to reach the
  chunks where the two roundings differ.
* ``register`` / ``snapshot`` / ``subset`` carrying function objects, a
  late re-registration that leaks into no existing session, and the same
  two user policies (in ``jax.numpy`` for the reference, in torch for the
  port) through ``Engine.run``, ``sweep`` and ``continue_sweep``.
* The kernel route's refusal of a user policy, by name (the kernel
  replaced by its plain contract on the CPU; the card itself in
  ``tests/test_torch_cuda.py``), and that an unselected user policy does
  not stop it.
* A donated state is consumed: passing it again raises.

Registration changes both packages' module dicts: the ``registered``
fixture restores both after each test. Every comparison is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jcore
from repro.core import counters as j_ctr, policies as j_pol
from repro.core import table as j_table
from repro.sweep import SweepSpec as JSpec

import repro_torch
import repro_torch.core as tcore
from repro_torch.core import counters as t_ctr, policies as t_pol
from repro_torch.core import table as t_table
from repro_torch.core.indexing import take_lane
from repro_torch.kernels import chunk_step as tcs
from repro_torch.sweep import SweepSpec as TSpec

from conftest import make_churn_trace, make_trace_arrays
from test_torch_core import POLICIES, T, assert_same, t_params, to_np
from test_torch_scan import energy_fma, plain_kernel
from test_torch_sweep import _assert_sweeps_equal


# ------------------------------------------------------------ helpers
@pytest.fixture
def registered():
    """``reg(name, jax_fn, torch_fn)`` registers a policy in both
    packages; both module dicts are restored afterwards, so no later
    test snapshots a test policy."""
    saved = dict(j_pol.POLICIES), dict(t_pol.POLICIES)

    def reg(name, jfn, tfn):
        j_pol.register(name)(jfn)
        t_pol.register(name)(tfn)
    yield reg
    for mod, old in zip((j_pol, t_pol), saved):
        mod.POLICIES.clear()
        mod.POLICIES.update(old)


def j_user_hotness(cfg, params, table, ptr, pages, is_write, valid):
    return j_pol.hotness_policy(cfg, params, table, ptr, pages, is_write,
                                valid)


def t_user_hotness(cfg, params, table, ptr, pages, is_write, valid):
    return t_pol.hotness_policy(cfg, params, table, ptr, pages, is_write,
                                valid)


def j_user_write_hot(cfg, params, table, ptr, pages, is_write, valid):
    """Promote the hottest slow page WRITTEN in the chunk; CLOCK victim."""
    cand, heat = j_pol._chunk_candidate(table, pages, valid,
                                        extra_mask=is_write)
    victim, vfound, skip = j_pol._clock_victim(table, ptr,
                                               params.n_fast_pages)
    want = vfound & (heat >= params.hot_threshold) & \
        (heat > j_table.hotness_at(table, victim))
    new_ptr = (ptr + skip + want.astype(jnp.int32)) % params.n_fast_pages
    return want, cand, victim, new_ptr


def t_user_write_hot(cfg, params, table, ptr, pages, is_write, valid):
    """Promote the hottest slow page WRITTEN in the chunk; CLOCK victim."""
    cand, heat = t_pol._chunk_candidate(table, pages, valid,
                                        extra_mask=is_write)
    victim, vfound, skip = t_pol._clock_victim(table, ptr,
                                               params.n_fast_pages)
    want = vfound & (heat >= params.hot_threshold) & \
        (heat > take_lane(table, victim, t_table.HOTNESS))
    new_ptr = (ptr + skip + want.to(torch.int32)) % params.n_fast_pages
    return want, cand, victim, new_ptr


def _register_users(reg):
    reg("user_hotness", j_user_hotness, t_user_hotness)
    reg("user_write_hot", j_user_write_hot, t_user_write_hot)


def _platforms(**kw):
    kw = {**dict(chunk=16, hot_threshold=2, decay_every=8), **kw}
    return jcore.small_platform(**kw), tcore.small_platform(**kw)


def _traces(cfg_j, n, seed, hot_fraction=0.5):
    arrays = make_trace_arrays(cfg_j, n, np.random.default_rng(seed),
                               hot_fraction=hot_fraction)
    return (jcore.Trace(*map(jnp.asarray, arrays)),
            tcore.Trace(*map(T, arrays)))


def _point(res, i):
    return jax.tree.map(lambda x: np.asarray(x)[i], to_np(res.states)), \
        {k: np.asarray(v[i]) for k, v in res.outs.items()}


@pytest.fixture
def kernel_route(monkeypatch):
    """The kernel route on the CPU: ``chunk_step_cuda`` replaced by its
    plain contract, which counts its launches."""
    launches = []

    def counted(*a, **kw):
        launches.append(1)
        return plain_kernel(*a, **kw)
    monkeypatch.setattr(tcs, "chunk_step_cuda", counted)
    monkeypatch.setattr(tcs, "use_chunk_step_kernel",
                        lambda cfg, t: cfg.chunk_step_kernel != "off")
    return launches


# ------------------------------------------------------------- energy
COEFFICIENTS = {"default": None, "slow_tier": (2.1, 12.3)}


def _energy_params(coef):
    jp = jcore.small_platform().runtime()
    if coef is not None:
        jp = jp._replace(power_pj_per_bit_slow_read=jnp.float32(coef[0]),
                         power_pj_per_bit_slow_write=jnp.float32(coef[1]))
    return jp


def _chunks(seed, n_chunks=3000, n=16):
    rng = np.random.default_rng(seed)
    return dict(
        device=rng.integers(0, 2, (n_chunks, n)).astype(np.int32),
        is_write=rng.random((n_chunks, n)) < 0.4,
        size=rng.choice([64, 128, 4096], (n_chunks, n)).astype(np.int32),
        valid=rng.random((n_chunks, n)) < 0.9,
        latency=rng.integers(0, 90000, (n_chunks, n)).astype(np.int32),
        energy=(rng.random(n_chunks) * 1e6).astype(np.float32))


def _port_energy(jp, ch):
    """The port's update over every chunk at once (a point axis)."""
    b = len(ch["energy"])
    zero = t_ctr.Counters.zeros()
    c = t_ctr.Counters(*(x.expand(b).clone() for x in zero))
    c = c._replace(energy_pj=T(ch["energy"]))
    out = t_ctr.update(t_params(jp), c, device=T(ch["device"]),
                       is_write=T(ch["is_write"]), size=T(ch["size"]),
                       valid=T(ch["valid"]), latency=T(ch["latency"]),
                       held=torch.zeros(b, dtype=torch.int32))
    return out.energy_pj.numpy()


@pytest.mark.parametrize("coef", COEFFICIENTS)
def test_energy_matches_jitted_reference(coef):
    """The port's ``update`` equals ``jax.jit(update)`` bit for bit on
    3,000 random 16-request chunks."""
    jp = _energy_params(COEFFICIENTS[coef])
    ch = _chunks(1 if coef == "default" else 2)
    update = jax.jit(j_ctr.update)
    want = np.empty(len(ch["energy"]), np.float32)
    for i in range(len(want)):
        c = j_ctr.Counters.zeros()._replace(
            energy_pj=jnp.float32(ch["energy"][i]))
        want[i] = update(jp, c, device=jnp.asarray(ch["device"][i]),
                         is_write=jnp.asarray(ch["is_write"][i]),
                         size=jnp.asarray(ch["size"][i]),
                         valid=jnp.asarray(ch["valid"][i]),
                         latency=jnp.asarray(ch["latency"][i]),
                         held=jnp.int32(0)).energy_pj
    got = _port_energy(jp, ch)
    assert want.tobytes() == got.tobytes(), \
        f"{int((want != got).sum())} chunks differ"


@pytest.mark.parametrize("coef", COEFFICIENTS)
def test_energy_is_the_two_fma_formula(coef):
    """The same chunks against ``fma(8*bws, p_sw, fma(bits_fast, p_f,
    (8*brs) * p_sr))`` computed with exact fractions, then a float32 add;
    the form that rounds every product differs on some of them, so the
    data reaches the chunks where the order shows."""
    jp = _energy_params(COEFFICIENTS[coef])
    pn = {f: np.float32(getattr(jp, f)) for f in jp._fields
          if f.startswith("power")}
    ch = _chunks(1 if coef == "default" else 2)
    f32 = np.float32
    want, separate = [], []
    for i in range(len(ch["energy"])):
        v, slow = ch["valid"][i], ch["device"][i] == 1
        r, w = ~ch["is_write"][i] & v, ch["is_write"][i] & v
        size = ch["size"][i].astype(np.int64)
        brf, bwf, brs, bws = (f32(size[m].sum()) for m in
                              (r & ~slow, w & ~slow, r & slow, w & slow))
        e0 = ch["energy"][i]
        want.append(f32(e0 + energy_fma(pn, brf, bwf, brs, bws)))
        bits_fast = f32(f32(8.0) * f32(brf + bwf))
        sep = f32(f32(f32(bits_fast * pn["power_pj_per_bit_fast"])
                      + f32(f32(f32(8.0) * brs)
                            * pn["power_pj_per_bit_slow_read"]))
                  + f32(f32(f32(8.0) * bws)
                        * pn["power_pj_per_bit_slow_write"]))
        separate.append(f32(e0 + sep))
    want, separate = np.array(want, f32), np.array(separate, f32)
    got = _port_energy(jp, ch)
    assert want.tobytes() == got.tobytes(), \
        f"{int((want != got).sum())} chunks differ from the formula"
    assert (separate != want).sum() > 0


def test_engine_sweep_energy_matches_reference():
    """The sweep where the rounding order first showed: six policies x
    fast fractions (0.125, 0.5) x link latencies (40, 900) on an 83-request
    trace, then ``continue_sweep``; every point (2, 6, 8 and 10 differed
    before) equals the JAX package's, energy included."""
    kw = dict(chunk=16, max_inflight=4, issue_gap=0, hot_threshold=2)
    cfg_j, cfg_t = jcore.small_platform(**kw), tcore.small_platform(**kw)
    jt, tt = _traces(cfg_j, 83, seed=1)
    axes = dict(policies=POLICIES, fast_fractions=(0.125, 0.5),
                link_lats=(40, 900))
    jeng = repro.Engine(cfg_j)
    teng = repro_torch.Engine(cfg_t, device="cpu")
    jres = jeng.sweep(JSpec(base=cfg_j, **axes), jt)
    tres = teng.sweep(TSpec(base=cfg_t, **axes), tt)
    assert len(tres.points) == 24
    _assert_sweeps_equal(jres, tres, "sweep")
    jcont = jeng.continue_sweep(jres, jt)
    tcont = teng.continue_sweep(tres, tt)
    _assert_sweeps_equal(jcont, tcont, "continue_sweep")


# ----------------------------------------------------------- registry
def test_registry_snapshot_and_subset():
    """As ``tests/test_engine.py``: the snapshot carries the function
    objects, a subset the same objects, names and ids as the JAX
    package's."""
    reg = t_pol.PolicyRegistry.snapshot()
    assert reg.names == repro.PolicyRegistry.snapshot().names
    assert "hotness" in reg and reg.index("hotness") == \
        t_pol.policy_id("hotness")
    sub = reg.subset(["hotness", "static"])
    assert sub.names == ("hotness", "static")
    assert sub.fns[0] is t_pol.POLICIES["hotness"]
    assert sub.fns == (t_pol.hotness_policy, t_pol.static_policy)
    assert reg.builtin_ids == tuple(range(6)) and reg.user_policies() == ()
    with pytest.raises(KeyError, match="not in this registry"):
        sub.index("stream")
    with pytest.raises(KeyError, match="unknown policy"):
        t_pol.PolicyRegistry.snapshot(("typo",))


def test_register_freezes_function_objects(registered):
    """``register`` writes the module dict; a snapshot holds the function
    objects of the moment; two snapshots of an unchanged dict are equal,
    one taken after a re-registration is not; ids follow registration
    order in both packages; a user entry maps to no built-in."""
    before = t_pol.PolicyRegistry.snapshot()
    _register_users(registered)
    reg = t_pol.PolicyRegistry.snapshot()
    assert reg == t_pol.PolicyRegistry.snapshot()
    assert hash(reg) == hash(t_pol.PolicyRegistry.snapshot())
    assert reg != before
    assert reg.names == repro.PolicyRegistry.snapshot().names
    for name in ("user_hotness", "user_write_hot"):
        assert t_pol.policy_id(name) == j_pol.policy_id(name)
    assert reg.fns[reg.index("user_write_hot")] is t_user_write_hot
    assert reg.builtin_ids == (*range(6), -1, -1)
    assert reg.user_policies() == ("user_hotness", "user_write_hot")
    assert reg.user_policies([0, 6]) == ("user_hotness",)
    sub = reg.subset(["user_write_hot", "hotness"])
    assert sub.fns == (t_user_write_hot, t_pol.hotness_policy)
    assert sub.builtin_ids == (-1, 1)

    def impostor(cfg, params, table, ptr, pages, is_write, valid):
        return t_pol.static_policy(cfg, params, table, ptr, pages, is_write,
                                   valid)
    t_pol.register("hotness")(impostor)
    after = t_pol.PolicyRegistry.snapshot()
    assert after != reg and after.names == reg.names
    assert reg.fns[1] is t_pol.hotness_policy and after.fns[1] is impostor
    assert after.user_policies() == ("hotness", "user_hotness",
                                      "user_write_hot")
    assert sub.fns[1] is t_pol.hotness_policy


def test_frozen_registry_is_immune_to_late_registration(registered):
    """As ``tests/test_engine.py``: an impostor registered as ``hotness``
    after a session's snapshot leaves that session unchanged (it still
    migrates), while a new session runs the impostor (it never
    migrates); both packages alike."""
    cfg_j, cfg_t = _platforms(chunk=8, decay_every=16)
    jt, tt = _traces(cfg_j, 64, seed=0, hot_fraction=0.4)
    jeng, teng = repro.Engine(cfg_j), repro_torch.Engine(cfg_t, device="cpu")
    want = teng.run(tt, donate=False)
    assert_same(jeng.run(jt, donate=False), want, "before")

    def j_impostor(cfg, params, table, ptr, pages, is_write, valid):
        return j_pol.static_policy(cfg, params, table, ptr, pages,
                                   is_write, valid)

    def t_impostor(cfg, params, table, ptr, pages, is_write, valid):
        return t_pol.static_policy(cfg, params, table, ptr, pages,
                                   is_write, valid)
    registered("hotness", j_impostor, t_impostor)
    assert t_impostor not in teng.registry.fns
    again = teng.run(tt, donate=False)
    assert_same(to_np(want), again, "after")
    assert int(again.state.dma.swaps_done) > 0
    fresh = repro_torch.Engine(cfg_t, device="cpu")
    assert fresh.registry != teng.registry
    other = fresh.run(tt, donate=False)
    assert int(other.state.dma.swaps_done) == 0
    assert_same(repro.Engine(cfg_j).run(jt, donate=False), other, "impostor")


# ------------------------------------------------------ user policies
@pytest.mark.parametrize("policy", ["user_hotness", "user_write_hot"])
def test_user_policy_run_matches_jax(registered, policy):
    """``Engine.run`` with a user policy as the config's policy, fresh
    and continued: state and outputs equal the JAX package's;
    ``user_hotness`` also equals ``hotness``."""
    _register_users(registered)
    cfg_j, cfg_t = _platforms(policy=policy, write_weight=3)
    jt, tt = _traces(cfg_j, 150, seed=4)
    jeng, teng = repro.Engine(cfg_j), repro_torch.Engine(cfg_t, device="cpu")
    jr, tr = jeng.run(jt), teng.run(tt)
    assert_same(jr, tr, "fresh")
    if policy == "user_hotness":
        hot = repro_torch.Engine(cfg_t.with_(policy="hotness"),
                                 device="cpu").run(tt)
        assert_same(to_np(hot), tr, "hotness")
    jr2, tr2 = jeng.run(jt, state=jr.state), teng.run(tt, state=tr.state)
    assert_same(jr2, tr2, "continued")
    assert int(tr2.state.dma.swaps_done) > 0


@pytest.mark.parametrize("resolver", ["dense", "segmented"])
def test_user_policy_sweep_matches_jax(registered, resolver):
    """The six built-ins and both user policies in one sweep (both bank
    resolvers), then ``continue_sweep``: every point equals the JAX
    package's; ``user_hotness`` points equal their ``hotness`` points."""
    _register_users(registered)
    cfg_j, cfg_t = _platforms(bank_resolver=resolver, write_weight=3)
    jt, tt = _traces(cfg_j, 120, seed=5)
    jt2, tt2 = _traces(cfg_j, 77, seed=6)
    names = (*POLICIES, "user_hotness", "user_write_hot")
    axes = dict(policies=names, fast_fractions=(0.125, 0.25))
    jeng, teng = repro.Engine(cfg_j), repro_torch.Engine(cfg_t, device="cpu")
    jres = jeng.sweep(JSpec(base=cfg_j, **axes), jt)
    tres = teng.sweep(TSpec(base=cfg_t, **axes), tt)
    assert tres.registry.names == names
    _assert_sweeps_equal(jres, tres, "sweep")
    by_policy = {}
    for i, p in enumerate(tres.points):
        by_policy.setdefault(p.cfg.policy, []).append(i)
    for a, b in zip(by_policy["hotness"], by_policy["user_hotness"]):
        sa, oa = _point(tres, a)
        sb, ob = _point(tres, b)
        assert_same(sa, sb, "user_hotness state")
        assert_same(oa, ob, "user_hotness outs")
    jcont = jeng.continue_sweep(jres, jt2)
    tcont = teng.continue_sweep(tres, tt2)
    _assert_sweeps_equal(jcont, tcont, "continue_sweep")


def test_user_policy_takes_min_wear(registered):
    """A user policy that declares ``min_wear`` gets the emulator's global
    min-wear register: a copy of ``wear_level`` equals the built-in and
    the JAX package's, and the chunk-local floor (``min_wear=None``)
    differs on this workload."""
    def j_wear(cfg, params, table, ptr, pages, is_write, valid,
               min_wear=None):
        return j_pol.wear_level_policy(cfg, params, table, ptr, pages,
                                       is_write, valid, min_wear=min_wear)

    def t_wear(cfg, params, table, ptr, pages, is_write, valid,
               min_wear=None):
        return t_pol.wear_level_policy(cfg, params, table, ptr, pages,
                                       is_write, valid, min_wear=min_wear)

    def j_local(cfg, params, table, ptr, pages, is_write, valid):
        return j_pol.wear_level_policy(cfg, params, table, ptr, pages,
                                       is_write, valid)

    def t_local(cfg, params, table, ptr, pages, is_write, valid):
        return t_pol.wear_level_policy(cfg, params, table, ptr, pages,
                                       is_write, valid)
    registered("user_wear", j_wear, t_wear)
    registered("user_wear_local", j_local, t_local)
    kw = dict(chunk=16, hot_threshold=2, decay_every=4, wear_slack=2)
    cfg_j, cfg_t = jcore.small_platform(**kw), tcore.small_platform(**kw)
    arrays = make_churn_trace(cfg_j, 1024, hot_w=12, period=128,
                              write_frac=0.7)
    jt = jcore.Trace(*map(jnp.asarray, arrays))
    tt = tcore.Trace(*map(T, arrays))
    names = ("wear_level", "user_wear", "user_wear_local")
    jres = repro.Engine(cfg_j).sweep(JSpec(base=cfg_j, policies=names), jt)
    tres = repro_torch.Engine(cfg_t, device="cpu").sweep(
        TSpec(base=cfg_t, policies=names), tt)
    _assert_sweeps_equal(jres, tres, "sweep")
    s0, o0 = _point(tres, 0)
    s1, o1 = _point(tres, 1)
    assert_same(s0, s1, "user_wear state")
    assert_same(o0, o1, "user_wear outs")
    s2, _ = _point(tres, 2)
    assert not np.array_equal(s0["table"], s2["table"])


# ------------------------------------------------ the kernel's refusal
def test_kernel_route_refuses_user_policy_by_name(registered, kernel_route):
    """On the kernel route (``"auto"``; the kernel replaced by its plain
    contract) a dispatch that selects a user policy raises a ValueError
    naming it and ``chunk_step_kernel="off"``, in ``run``, ``sweep`` and
    a pre-stacked sweep; nothing launches and nothing changes route.
    ``"off"`` runs it."""
    _register_users(registered)
    _, cfg_t = _platforms(policy="user_write_hot")
    _, tt = _traces(jcore.small_platform(), 64, seed=2)
    eng = repro_torch.Engine(cfg_t, device="cpu")
    with pytest.raises(ValueError, match="'user_write_hot'.*off"):
        eng.run(tt)
    with pytest.raises(ValueError, match="'user_hotness'"):
        eng.sweep(TSpec(base=cfg_t, policies=("hotness", "user_hotness")),
                  tt)
    params = repro_torch.engine.stack_params(
        [p for p in repro_torch.sweep.build_points(
            TSpec(base=cfg_t.with_(policy="hotness"),
                  link_lats=(40, 600)))])
    bad = params._replace(policy_id=torch.tensor([1, 7], dtype=torch.int32))
    with pytest.raises(ValueError, match="'user_write_hot'"):
        eng.sweep(bad, tt)
    with pytest.raises(ValueError, match="'user_write_hot'"):
        eng.run(tt, params=eng.params._replace(
            policy_id=torch.tensor(99, dtype=torch.int32)))
    assert kernel_route == []
    off = repro_torch.Engine(cfg_t.with_(chunk_step_kernel="off"),
                             device="cpu")
    want = repro_torch.Engine(cfg_t.with_(chunk_step_kernel="off"),
                              device="cpu").run(tt)
    assert_same(to_np(want), off.run(tt), "off")
    assert kernel_route == []


def test_unselected_user_policy_keeps_the_kernel(registered, kernel_route):
    """A registered but unselected user policy does not stop the kernel:
    ``Engine(cfg)`` at ``hotness`` launches once and equals the loop; a
    built-in sweep and a pre-stacked batch of built-in ids too."""
    _register_users(registered)
    _, cfg_t = _platforms()
    _, tt = _traces(jcore.small_platform(), 64, seed=3)
    eng = repro_torch.Engine(cfg_t, device="cpu")
    assert "user_write_hot" in eng.registry
    got = eng.run(tt)
    assert kernel_route == [1]
    want = repro_torch.Engine(cfg_t.with_(chunk_step_kernel="off"),
                              device="cpu").run(tt)
    assert_same(to_np(want), got, "hotness")
    eng.sweep(TSpec(base=cfg_t, policies=("static", "hotness")), tt)
    params = eng.params._replace(policy_id=torch.tensor(5, dtype=torch.int32))
    eng.run(tt, params=params)
    assert kernel_route == [1, 1, 1]


def test_impostor_builtin_name_is_refused(registered, kernel_route):
    """A function re-registered as ``hotness`` is a user policy: refused
    on the kernel route, never run as the built-in."""
    def t_impostor(cfg, params, table, ptr, pages, is_write, valid):
        return t_pol.hotness_policy(cfg, params, table, ptr, pages,
                                    is_write, valid)
    registered("hotness", j_user_hotness, t_impostor)
    _, cfg_t = _platforms()
    _, tt = _traces(jcore.small_platform(), 64, seed=2)
    eng = repro_torch.Engine(cfg_t, device="cpu")
    assert eng.registry.builtin_ids[1] == -1
    with pytest.raises(ValueError, match="'hotness' is a user policy"):
        eng.run(tt)
    assert kernel_route == []


# ----------------------------------------------------- consumed states
@pytest.mark.parametrize("knobs", [
    dict(bank_resolver="dense", fuse_swap_gather=False),
    dict(bank_resolver="dense", fuse_swap_gather=True),
    dict(bank_resolver="segmented", fuse_swap_gather=False),
    dict(bank_resolver="segmented", fuse_swap_gather=True),
])
@pytest.mark.parametrize("donate", [False, True])
def test_engine_run_knobs_and_donation(knobs, donate):
    """As ``tests/test_engine.py``: every resolver / fusion knob, fresh
    and continued, donated or not, equals the JAX package's; a donated
    state is consumed (passing it again raises), an undonated one stays
    live."""
    cfg_j, cfg_t = _platforms(**knobs)
    jt, tt = _traces(cfg_j, 160, seed=0)
    jeng, teng = repro.Engine(cfg_j), repro_torch.Engine(cfg_t, device="cpu")
    j1, t1 = jeng.run(jt), teng.run(tt)
    assert_same(j1, t1, "fresh")
    j2 = jeng.run(jt, state=j1.state, donate=False)
    t2 = teng.run(tt, state=t1.state, donate=donate)
    assert_same(j2, t2, "continued")
    if donate:
        with pytest.raises(RuntimeError, match="donate=False"):
            teng.run(tt, state=t1.state)
    else:
        assert_same(j2, teng.run(tt, state=t1.state), "reused")


def test_engine_run_donates_passed_state_by_default():
    """As ``tests/test_engine.py``: the default donates; ``donate=False``
    keeps the caller's state; ``donate=True`` with no state raises."""
    _, cfg_t = _platforms()
    _, tt = _traces(jcore.small_platform(), 96, seed=0)
    engine = repro_torch.Engine(cfg_t, device="cpu")
    s0, _ = engine.run(tt)
    s1, _ = engine.run(tt, state=s0)
    assert s1 is not s0 and s1.table.data_ptr() == s0.table.data_ptr()
    with pytest.raises(RuntimeError, match="consumed"):
        engine.run(tt, state=s0)
    s2, _ = engine.run(tt, state=s1, donate=False)
    assert int(s2.clock) > int(s1.clock)
    engine.run(tt, state=s1)            # s1 stayed live
    with pytest.raises(ValueError, match="donate=True requires state="):
        engine.run(tt, donate=True)
    with pytest.raises(ValueError, match="donate=True requires state="):
        engine.run_stream([tt], donate=True)
    # A state mixing a consumed field into a live one is refused too.
    with pytest.raises(RuntimeError, match="consumed"):
        engine.run(tt, state=s2._replace(clock=s0.clock))


def test_run_stream_continues_and_consumes_state():
    """As ``tests/test_engine.py``: ``run_stream`` from a carried state
    equals one run of the whole trace, and consumes the state."""
    cfg_j, cfg_t = _platforms(decay_every=16)
    jt, tt = _traces(cfg_j, 96, seed=0, hot_fraction=0.4)
    engine = repro_torch.Engine(cfg_t, device="cpu")
    t2 = tcore.Trace(*(torch.cat([x, x]) for x in tt))
    want = engine.run(t2)
    s0, _ = engine.run(tt)
    got = engine.run_stream([tt], state=s0)
    assert torch.equal(got.outs["returns"], want.outs["returns"][96:])
    assert_same(to_np(want.state), got.state, "state")
    with pytest.raises(RuntimeError, match="consumed"):
        engine.run_stream([tt], state=s0)
    jeng = repro.Engine(cfg_j)
    j0 = jeng.run(jt).state
    assert_same(jeng.run_stream([jt], state=j0), got, "JAX")


def test_continue_sweep_consumes_the_result():
    """``continue_sweep`` donates by default: the result passed in is
    consumed; ``donate=False`` keeps it; the continued sweeps equal the
    JAX package's."""
    cfg_j, cfg_t = _platforms()
    jt, tt = _traces(cfg_j, 64, seed=1)
    axes = dict(policies=("hotness", "static"), link_lats=(40, 600))
    jeng, teng = repro.Engine(cfg_j), repro_torch.Engine(cfg_t, device="cpu")
    jres = jeng.sweep(JSpec(base=cfg_j, **axes), jt)
    tres = teng.sweep(TSpec(base=cfg_t, **axes), tt)
    kept = teng.continue_sweep(tres, tt, donate=False)
    jkept = jeng.continue_sweep(jres, jt, donate=False)
    _assert_sweeps_equal(jkept, kept, "kept")
    cont = teng.continue_sweep(tres, tt)
    _assert_sweeps_equal(jkept, cont, "donated")
    with pytest.raises(RuntimeError, match="consumed"):
        teng.continue_sweep(tres, tt)
    with pytest.raises(RuntimeError, match="consumed"):
        teng.sweep(TSpec(base=cfg_t, **axes), tt, states=tres.states)
    again = teng.continue_sweep(cont, tt)
    _assert_sweeps_equal(jeng.continue_sweep(jkept, jt), again, "again")


def test_contracts_keep_the_state_live():
    """The pin contracts edit a state in place and return it live."""
    from repro_torch.serve.contracts import release_pin_pages, \
        stamp_pin_pages
    _, cfg_t = _platforms()
    _, tt = _traces(jcore.small_platform(), 64, seed=0)
    engine = repro_torch.Engine(cfg_t, device="cpu")
    s = engine.run(tt).state
    s2 = stamp_pin_pages(s, [0, 9], width=4)
    s3 = release_pin_pages(s2, [9], width=4)
    assert s3 is s
    got = engine.run(tt, state=s3)
    assert int(got.state.chunk_idx) == 8
    with pytest.raises(RuntimeError, match="consumed"):
        engine.run(tt, state=s)
