"""The PyTorch port's core modules against the JAX package, bit for bit.

Every input is built with numpy from a seed and handed to both packages;
JAX objects cross over through ``repro_torch.convert``. All comparisons
are exact (dtype, shape and bytes), floats included. The helpers at the
top are shared by the other ``test_torch_*`` files.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import consistency as j_cons, counters as j_ctr
from repro.core import dma as j_dma, faults as j_faults
from repro.core import latency as j_lat, policies as j_pol
from repro.core import table as j_table

import repro_torch.core as tcore
from repro_torch import convert
from repro_torch.core import consistency as t_cons, counters as t_ctr
from repro_torch.core import dma as t_dma, faults as t_faults
from repro_torch.core import latency as t_lat, policies as t_pol
from repro_torch.core import table as t_table

POLICIES = ("static", "hotness", "write_bias", "stream", "hotness_global",
            "wear_level")


# ------------------------------------------------------------------ helpers
def to_np(x):
    """A JAX pytree of NamedTuples / dicts / arrays -> numpy dicts."""
    if hasattr(x, "_asdict"):
        return {k: to_np(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: to_np(v) for k, v in x.items()}
    return np.asarray(x)


def t_params(jp):
    return convert.params_from_numpy(to_np(jp))


def t_state(js):
    return convert.state_from_numpy(to_np(js))


def t_plan(jplan):
    return convert.faults_from_numpy(to_np(jplan))


def T(x):
    """numpy -> torch (CPU), keeping the dtype."""
    return torch.from_numpy(np.array(x, order="C", copy=True))


def assert_same(j, t, path="value"):
    """Exact equality of a JAX result and the port's: same structure,
    shapes, dtypes and bytes."""
    if hasattr(j, "_asdict"):
        for k in j._fields:
            tk = t[k] if isinstance(t, dict) else getattr(t, k)
            assert_same(getattr(j, k), tk, f"{path}.{k}")
        return
    if isinstance(j, dict):
        for k in j:
            tk = t[k] if isinstance(t, dict) else getattr(t, k)
            assert_same(j[k], tk, f"{path}[{k!r}]")
        return
    if isinstance(j, (tuple, list)):
        assert len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            assert_same(a, b, f"{path}[{i}]")
        return
    a = np.asarray(j)
    b = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)
    assert a.shape == b.shape, f"{path}: shape {a.shape} vs {b.shape}"
    assert a.dtype == b.dtype, f"{path}: dtype {a.dtype} vs {b.dtype}"
    assert a.tobytes() == b.tobytes(), \
        f"{path}: first difference {np.argwhere(a != b)[:3].tolist()}" \
        f" jax={a.ravel()[:8]} torch={b.ravel()[:8]}"


def random_table(cfg, rng, *, flags=True):
    """An adversarial packed table: random lanes (OWNER partly out of
    range), pins, poison and tombstones."""
    n = cfg.n_pages
    tab = np.zeros((n, 8), np.int32)
    tab[:, 0] = rng.integers(0, 2, n)
    tab[:, 1] = rng.integers(0, n, n)
    tab[:, 2] = rng.integers(0, 12, n)
    tab[:, 3] = rng.integers(0, 300, n)
    tab[:, 4] = rng.integers(-3, n + 3, n)
    tab[:, 5] = rng.integers(0, 1000, n)
    if flags:
        choices = np.array([0, 0, 0, 0, j_table.PIN_FAST, j_table.PIN_SLOW,
                            j_table.POISONED,
                            j_table.POISONED | j_table.RETIRED], np.int32)
        tab[:, 6] = rng.choice(choices, n)
    return tab


# --------------------------------------------------------- config / table
def test_static_config_and_technologies_are_copies():
    for cfg_j, cfg_t in ((jcore.paper_platform(), tcore.paper_platform()),
                         (jcore.small_platform(chunk=8),
                          tcore.small_platform(chunk=8))):
        assert jcore.static_key(cfg_j) == tcore.static_key(cfg_t)
        assert cfg_j.n_pages == cfg_t.n_pages
        assert cfg_j.dma_cycles_per_subblock == cfg_t.dma_cycles_per_subblock
    for name, tech in jcore.TECHNOLOGIES.items():
        assert tcore.TECHNOLOGIES[name].__dict__ == tech.__dict__


@pytest.mark.parametrize("policy", POLICIES)
def test_runtime_params_from_config(policy):
    cfg_j = jcore.small_platform(policy=policy, pin_fast_fraction=0.3)
    cfg_t = tcore.small_platform(policy=policy, pin_fast_fraction=0.3)
    jp = jcore.RuntimeParams.from_config(cfg_j)
    assert_same(jp, tcore.RuntimeParams.from_config(cfg_t), "params")
    assert_same(jp, t_params(jp), "converted")


@pytest.mark.parametrize("pin", [0.0, 0.3])
@pytest.mark.parametrize("geometry", ["small", "paper"])
def test_init_state_matches(pin, geometry):
    if geometry == "small":
        cfg_j = jcore.small_platform(pin_fast_fraction=pin)
        cfg_t = tcore.small_platform(pin_fast_fraction=pin)
    else:
        cfg_j = jcore.paper_platform().with_(pin_fast_fraction=pin)
        cfg_t = tcore.paper_platform().with_(pin_fast_fraction=pin)
    js = jcore.init_state(cfg_j, cfg_j.runtime())
    ts = tcore.init_state(cfg_t, cfg_t.runtime())
    assert_same(js, ts, "state")
    assert_same(js, convert.state_to_numpy(ts), "round trip")
    tcore.check_table(cfg_t, ts.table)


def test_init_table_pin_count_is_a_float32_floor():
    cfg_j, cfg_t = jcore.small_platform(), tcore.small_platform()
    for nf in (1, 7, 8, 10, 33):
        for frac in (0.1, 0.3, 0.7, 0.99, 1.0):
            a = j_table.init_table(cfg_j, jnp.int32(nf), jnp.float32(frac))
            b = t_table.init_table(cfg_t, torch.tensor(nf, dtype=torch.int32),
                                   torch.tensor(frac, dtype=torch.float32))
            assert_same(a, b, f"nf={nf} frac={frac}")


def test_table_helpers_match():
    rng = np.random.default_rng(5)
    cfg = jcore.small_platform()
    tab = random_table(cfg, rng)
    pages = np.array([0, 3, cfg.n_pages - 1, 9], np.int32)
    assert_same(j_table.set_flags(jnp.asarray(tab), pages, j_table.PIN_SLOW),
                t_table.set_flags(T(tab), pages, t_table.PIN_SLOW))
    assert_same(j_table.clear_flags(jnp.asarray(tab), pages),
                t_table.clear_flags(T(tab), pages))
    assert_same(j_table.decay_hotness(jnp.asarray(tab), 2),
                t_table.decay_hotness(T(tab), 2))
    assert_same(j_table.unpack(jnp.asarray(tab)), t_table.unpack(T(tab)))
    lanes = [tab[:, i] for i in range(7)]
    assert_same(j_table.pack_rows(*lanes), t_table.pack_rows(*map(T, lanes)))
    k = np.arange(5, dtype=np.int32)
    assert_same(j_table.swap_commit_lanes(jnp.asarray(k)),
                t_table.swap_commit_lanes(T(k)))
    bad = tab.copy()
    bad[0, j_table.HOTNESS] = -1
    with pytest.raises(AssertionError):
        t_table.check_table(cfg, bad)


@pytest.mark.parametrize("seed", range(3))
def test_saturating_weights_near_the_cap(seed):
    rng = np.random.default_rng(seed)
    n = 40
    targets = rng.integers(0, 6, n).astype(np.int32)
    w = rng.integers(0, 5, n).astype(np.int32)
    pre = (j_table.HOTNESS_CAP - rng.integers(0, 12, n)).astype(np.int32)
    assert_same(j_table.saturating_weights(jnp.asarray(targets),
                                           jnp.asarray(w), jnp.asarray(pre),
                                           j_table.HOTNESS_CAP),
                t_table.saturating_weights(T(targets), T(w), T(pre),
                                           t_table.HOTNESS_CAP))


# ------------------------------------------------------------------ latency
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_banks", [2, 16])
def test_maxplus_resolvers_and_in_order(seed, n_banks):
    rng = np.random.default_rng(seed)
    n = 64
    arrival = np.sort(rng.integers(0, 5000, n)).astype(np.int32)
    arrival[rng.random(n) < 0.1] = -(2 ** 30)          # invalid slots
    service = rng.integers(0, 400, n).astype(np.int32)
    bank = rng.integers(0, 2 * n_banks, n).astype(np.int32)
    free = rng.integers(0, 3000, 2 * n_banks).astype(np.int32)
    last = np.int32(rng.integers(0, 4000))
    assert_same(j_lat.maxplus_scan(jnp.asarray(arrival), jnp.asarray(service)),
                t_lat.maxplus_scan(T(arrival), T(service)), "maxplus")
    dense_j = j_lat.resolve_bank_queues(
        jnp.asarray(arrival), jnp.asarray(service), jnp.asarray(bank),
        2 * n_banks, jnp.asarray(free))
    for name, fn in (("dense", t_lat.resolve_bank_queues),
                     ("segmented", t_lat.resolve_bank_queues_segmented)):
        assert_same(dense_j, fn(T(arrival), T(service), T(bank), 2 * n_banks,
                                T(free)), name)
    assert_same(j_lat.resolve_bank_queues_segmented(
        jnp.asarray(arrival), jnp.asarray(service), jnp.asarray(bank),
        2 * n_banks, jnp.asarray(free)),
        t_lat.resolve_bank_queues_segmented(T(arrival), T(service), T(bank),
                                            2 * n_banks, T(free)),
        "segmented vs segmented")
    assert_same(j_cons.in_order_returns(jnp.asarray(arrival),
                                        jnp.asarray(last)),
                t_cons.in_order_returns(T(arrival), T(last)), "in order")


def test_pick_bank_resolver():
    for kw in ({}, {"n_banks": 4}, {"bank_resolver": "dense"},
               {"bank_resolver": "segmented", "n_banks": 2}):
        assert j_lat.pick_bank_resolver(jcore.small_platform(**kw)) == \
            t_lat.pick_bank_resolver(tcore.small_platform(**kw))
    assert t_lat.pick_bank_resolver(tcore.paper_platform()) == "segmented"
    with pytest.raises(ValueError):
        t_lat.pick_bank_resolver(tcore.small_platform(bank_resolver="x"))


@pytest.mark.parametrize("tech", sorted(jcore.TECHNOLOGIES))
def test_service_cycles_every_technology_and_size(tech):
    size = np.arange(1, 4097, dtype=np.int32)
    is_write = (size % 3 == 0)
    dev = (size % 2).astype(np.int32)
    kw = dict(slow=jcore.TECHNOLOGIES[tech],
              link_bytes_per_cycle=jcore.TECHNOLOGIES[tech].bytes_per_cycle)
    jp = jcore.small_platform(**kw).runtime()
    tp = t_params(jp)
    assert_same(j_lat.device_service_cycles(jp, jnp.asarray(dev),
                                            jnp.asarray(is_write),
                                            jnp.asarray(size)),
                t_lat.device_service_cycles(tp, T(dev), T(is_write), T(size)),
                "device")
    assert_same(j_lat.link_service_cycles(jp, jnp.asarray(size)),
                t_lat.link_service_cycles(tp, T(size)), "link")


def test_ceil_division_is_float32_exact():
    p = tcore.small_platform().runtime()   # link: 8.0 bytes/cycle
    assert t_lat.link_service_cycles(p, torch.tensor([64, 65, 16],
                                                     dtype=torch.int32)
                                     ).tolist() == [8, 9, 2]
    with pytest.raises(TypeError):
        t_lat.ceil_cycles(torch.tensor([64], dtype=torch.int32),
                          torch.tensor(8.0, dtype=torch.float64))


# ---------------------------------------------------------------------- dma
def _dma_case(cfg, rng):
    active = int(rng.integers(0, 2))
    a = int(rng.integers(-1, cfg.n_pages))
    b = int(rng.integers(-1, cfg.n_pages))
    return j_dma.DMAState(active=jnp.int32(active), page_a=jnp.int32(a),
                          page_b=jnp.int32(b),
                          start=jnp.int32(rng.integers(0, 500)),
                          swaps_done=jnp.int32(rng.integers(0, 9)))


@pytest.mark.parametrize("seed", range(6))
def test_dma_redirect_plan_commit_maybe_start(seed):
    rng = np.random.default_rng(seed)
    cfg_j, cfg_t = jcore.small_platform(), tcore.small_platform()
    jp = cfg_j.runtime()
    tp = t_params(jp)
    tab = random_table(cfg_j, rng)
    jd = _dma_case(cfg_j, rng)
    td = t_dma.DMAState(*(T(np.asarray(x)) for x in jd))
    n = 32
    page = np.where(rng.random(n) < 0.5, np.asarray(jd.page_a),
                    rng.integers(0, cfg_j.n_pages, n)).astype(np.int32)
    off = (rng.integers(0, 64, n) * 64).astype(np.int32)
    t = rng.integers(0, 3000, n).astype(np.int32)
    dev = rng.integers(0, 2, n).astype(np.int32)
    frm = rng.integers(0, 50, n).astype(np.int32)
    ra, rb = tab[3], tab[11]
    assert_same(j_dma.redirect(cfg_j, jd, *map(jnp.asarray, (page, off, t, dev,
                                                             frm, ra, rb)), jp),
                t_dma.redirect(cfg_t, td, *map(T, (page, off, t, dev, frm, ra,
                                                   rb)), tp), "redirect")
    now = np.int32(rng.integers(0, 3000))
    rescue = int(np.asarray(jd.page_a)) if seed % 2 else -1
    ra[j_table.FLAGS] |= j_table.POISONED
    assert_same(j_dma.plan_commit(cfg_j, jd, jnp.asarray(now), jnp.asarray(ra),
                                  jnp.asarray(rb), jp, jnp.int32(rescue)),
                t_dma.plan_commit(cfg_t, td, T(now), T(ra), T(rb), tp,
                                  torch.tensor(rescue, dtype=torch.int32)),
                "plan_commit")
    assert_same(j_dma.maybe_complete(cfg_j, jd, jnp.asarray(now),
                                     jnp.asarray(tab), jp),
                t_dma.maybe_complete(cfg_t, td, T(now), T(tab), tp),
                "maybe_complete")
    want = np.bool_(rng.random() < 0.8)
    pa, pb = np.int32(rng.integers(0, 64)), np.int32(rng.integers(0, 64))
    assert_same(j_dma.maybe_start(jd, jnp.asarray(want), jnp.asarray(pa),
                                  jnp.asarray(pb), jnp.asarray(now),
                                  jnp.asarray(tab)),
                t_dma.maybe_start(td, T(want), T(pa), T(pb), T(now), T(tab)),
                "maybe_start")


# ----------------------------------------------------------------- policies
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", range(3))
def test_policy_on_random_tables(policy, seed):
    rng = np.random.default_rng(100 + seed)
    cfg_j = jcore.small_platform(policy=policy, hot_threshold=2)
    cfg_t = tcore.small_platform(policy=policy, hot_threshold=2)
    jp = cfg_j.runtime()
    tp = t_params(jp)
    tab = random_table(cfg_j, rng)
    n = 16
    pages = rng.integers(-2, cfg_j.n_pages + 2, n).astype(np.int32)
    if seed == 1:   # a stride the stream policy recognises
        pages = (cfg_j.n_fast_pages + 2 * np.arange(n)).astype(np.int32)
    is_write = rng.random(n) < 0.4
    valid = rng.random(n) < 0.9
    ptr = np.int32(rng.integers(0, cfg_j.n_fast_pages))
    args_j = (jnp.asarray(tab), jnp.asarray(ptr), jnp.asarray(pages),
              jnp.asarray(is_write), jnp.asarray(valid))
    args_t = (T(tab), T(ptr), T(pages), T(is_write), T(valid))
    kw_j, kw_t = {}, {}
    if policy == "wear_level":
        kw_j = {"min_wear": jnp.int32(40)}
        kw_t = {"min_wear": torch.tensor(40, dtype=torch.int32)}
    assert_same(j_pol.get(policy)(cfg_j, jp, *args_j, **kw_j),
                t_pol.get(policy)(cfg_t, tp, *args_t, **kw_t), policy)


def test_registry_order_and_ids():
    assert tuple(t_pol.POLICIES) == POLICIES
    assert tuple(j_pol.POLICIES)[:6] == POLICIES
    reg = t_pol.PolicyRegistry.snapshot()
    assert reg.builtin_ids == tuple(range(6))
    sub = reg.subset(["wear_level", "static"])
    assert sub.builtin_ids == (5, 0) and sub.index("static") == 1
    with pytest.raises(KeyError):
        t_pol.PolicyRegistry.snapshot(["user_policy"])


# ------------------------------------------------------ faults / counters
@pytest.mark.parametrize("seed", range(3))
def test_seeded_and_padded_plans_match(seed):
    pages = np.arange(8, 64, dtype=np.int32)
    kw = dict(pages=pages, n_chunks=20, n_deaths=3, n_transient=5,
              start_chunk=2)
    jplan = j_faults.seeded_plan(seed, **kw)
    tplan = t_faults.seeded_plan(seed, **kw)
    assert_same(jplan, tplan, "seeded")
    assert_same(j_faults.pad_plan(jplan, 9, 6),
                t_faults.pad_plan(tplan, 9, 6), "padded")
    assert_same(j_faults.FaultPlan.empty(), t_faults.FaultPlan.empty(),
                "empty")


@pytest.mark.parametrize("seed", range(3))
def test_counter_update_is_bitwise(seed):
    rng = np.random.default_rng(seed)
    n = 64
    jp = jcore.small_platform().runtime()
    tp = t_params(jp)
    dev = rng.integers(0, 2, n).astype(np.int32)
    iw = rng.random(n) < 0.4
    size = rng.choice([64, 128, 4096], n).astype(np.int32)
    valid = rng.random(n) < 0.9
    lat = rng.integers(0, 90000, n).astype(np.int32)
    poi = rng.random(n) < 0.1
    inj = rng.random(n) < 0.1
    jc = j_ctr.Counters.zeros()
    jc = jc._replace(energy_pj=jnp.float32(1234.5678),
                     sum_read_latency=jnp.float32(2.0 ** 25 + 3))
    tc = t_ctr.Counters(*(T(np.asarray(x)) for x in jc))
    update = jax.jit(j_ctr.update)   # the reference as it runs
    for _ in range(3):
        jc = update(jp, jc, device=jnp.asarray(dev),
                          is_write=jnp.asarray(iw), size=jnp.asarray(size),
                          valid=jnp.asarray(valid), latency=jnp.asarray(lat),
                          held=jnp.int32(3), poisoned=jnp.asarray(poi),
                          retired=jnp.asarray(True),
                          injected=jnp.asarray(inj))
        tc = t_ctr.update(tp, tc, device=T(dev), is_write=T(iw), size=T(size),
                          valid=T(valid), latency=T(lat),
                          held=torch.tensor(3, dtype=torch.int32),
                          poisoned=T(poi), retired=torch.tensor(True),
                          injected=T(inj))
    assert_same(jc, tc, "counters")
    assert j_ctr.summary(jc) == t_ctr.summary(tc)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
