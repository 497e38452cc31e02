"""The port's kernel modules against the JAX package, bit for bit.

On the CPU each kernel wrapper takes its plain PyTorch version, which is
held here against the JAX reference and (once per kernel) against the
interpreted Pallas kernel. The CUDA kernels themselves run only on a
card: the ``cuda``-marked test holds them against their plain versions
there and skips elsewhere (``python3 chip_smoke.py`` does the same at the
paper's geometry).
"""
import importlib
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import faults as j_faults, table as j_table
from repro.kernels import chunk_step as jcs
from repro.kernels import ref as j_ref

import repro_torch.core as tcore
from repro_torch.core.policies import PolicyRegistry
from repro_torch.kernels import chunk_step as tcs
from repro_torch.kernels import hmmu_lookup as t_hl, ops as t_ops

from test_torch_core import (POLICIES, T, assert_same, t_params, t_plan,
                             t_state)

j_hl = importlib.import_module("repro.kernels.hmmu_lookup")
CSRC = pathlib.Path(t_hl.__file__).resolve().parent / "csrc"


# ------------------------------------------------------------ kernel A
def _lookup_case(seed, b=3, n_pages=40, m=16):
    rng = np.random.default_rng(seed)
    table = rng.integers(-50, 1000, (b, n_pages, 8)).astype(np.int32)
    pages = rng.integers(0, n_pages, (b, m)).astype(np.int32)
    pages[:, 0] = -1            # negative pages clamp to row 0
    pages[:, 1] = n_pages       # past the end clamps to the last row
    pages[:, 2] = -n_pages - 7
    pages[:, 3] = 10 * n_pages
    extra = rng.integers(-3, n_pages + 3, (b, 2)).astype(np.int32)
    return table, pages, extra


@pytest.mark.parametrize("seed", range(3))
def test_hmmu_lookup_plain_matches_jax(seed):
    table, pages, extra = _lookup_case(seed)
    want = j_ref.hmmu_lookup(jnp.asarray(table), jnp.asarray(pages))
    assert_same(want, t_hl.hmmu_lookup_plain(T(table), T(pages)), "plain")
    assert_same(want, t_ops.hmmu_lookup(T(table), T(pages)), "dispatch")
    want_f = j_ref.hmmu_lookup_fused(jnp.asarray(table), jnp.asarray(pages),
                                     jnp.asarray(extra))
    assert_same(want_f, t_ops.hmmu_lookup_fused(T(table), T(pages),
                                                *T(extra).unbind(-1)),
                "fused")


def test_hmmu_lookup_matches_interpreted_pallas_kernel():
    table, pages, extra = _lookup_case(7)
    want = j_hl.hmmu_lookup(jnp.asarray(table), jnp.asarray(pages),
                            interpret=True)
    assert_same(want, t_hl.hmmu_lookup(T(table), T(pages)), "kernel")
    want_f = j_hl.hmmu_lookup_fused(jnp.asarray(table), jnp.asarray(pages),
                                    jnp.asarray(extra), interpret=True)
    assert_same(want_f, t_hl.hmmu_lookup_fused(T(table), T(pages),
                                               *T(extra).unbind(-1)),
                "fused kernel")


def test_hmmu_lookup_cuda_wrapper_rejects_cpu_tensors():
    table, pages, _ = _lookup_case(0)
    with pytest.raises(ValueError, match="CUDA"):
        t_hl.hmmu_lookup_cuda(T(table), T(pages))


# ------------------------------------------------------------ kernel B
_jstep = jax.jit(jcs.step_ref, static_argnums=(0, 1),
                 static_argnames=("seq",))


def _scenario(policy, *, endurance=2, n_chunks=6, chunk=8, seed=0,
              resolver="auto"):
    """The golden scenario (adversarial start state: pins, a poisoned
    page, a swap in flight) with endurance retirement and a fault plan
    holding deaths and transients."""
    kw = dict(chunk=chunk, hot_threshold=2, decay_every=4, policy=policy,
              endurance_budget=endurance, bank_resolver=resolver,
              write_weight=3)
    cfg_j, cfg_t = jcore.small_platform(**kw), tcore.small_platform(**kw)
    state = jcore.init_state(cfg_j, cfg_j.runtime())
    tab = j_table.set_flags(state.table, [0, 1], j_table.PIN_FAST)
    tab = j_table.set_flags(tab, [cfg_j.n_fast_pages + 1], j_table.PIN_SLOW)
    tab = j_table.set_flags(tab, [cfg_j.n_fast_pages + 3], j_table.POISONED)
    state = state._replace(table=tab, dma=state.dma._replace(
        active=jnp.int32(1), page_a=jnp.int32(cfg_j.n_fast_pages + 2),
        page_b=jnp.int32(cfg_j.n_fast_pages - 1), start=jnp.int32(0)))
    rng = np.random.default_rng(seed)
    n = n_chunks * chunk
    page = np.where(rng.random(n) < 0.5,
                    cfg_j.n_fast_pages + rng.integers(0, 6, n),
                    rng.integers(0, cfg_j.n_pages, n)).astype(np.int32)
    page[rng.random(n) < 0.2] = cfg_j.n_fast_pages + 2   # the swap pair
    off = (rng.integers(0, cfg_j.page_size // 64, n) * 64).astype(np.int32)
    iw = rng.random(n) < 0.5
    size = np.full(n, 64, np.int32)
    valid = np.ones(n, bool)
    valid[-3:] = False
    plan = j_faults.seeded_plan(seed, pages=np.arange(cfg_j.n_fast_pages,
                                                      cfg_j.n_pages),
                                n_chunks=n_chunks, n_deaths=2, n_transient=6)
    return cfg_j, cfg_t, state, (page, off, iw, size, valid), plan


def _j_scalars(s):
    return jcs.StepScalars(
        clock=s.clock, clock_ptr=s.clock_ptr, chunk_idx=s.chunk_idx,
        dma=s.dma, link_free_rx=s.link_free_rx, link_free_tx=s.link_free_tx,
        last_return=s.last_return, rescue_page=s.rescue_page,
        min_wear=s.min_wear, fault_cursor=s.fault_cursor)


def _t_scalars(s):
    return tcs.StepScalars(
        clock=s.clock, clock_ptr=s.clock_ptr, chunk_idx=s.chunk_idx,
        dma=s.dma, link_free_rx=s.link_free_rx, link_free_tx=s.link_free_tx,
        last_return=s.last_return, rescue_page=s.rescue_page,
        min_wear=s.min_wear, fault_cursor=s.fault_cursor)


def _run_steps(policy, seq, jax_step, **kw):
    cfg_j, cfg_t, js, arrays, jplan = _scenario(policy, **kw)
    jreg = jcore.PolicyRegistry.snapshot(POLICIES)
    treg = PolicyRegistry.snapshot()
    jp = cfg_j.runtime()
    tp = t_params(jp)
    ts = t_state(js)
    tplan = t_plan(jplan)
    # The policy travels in params.policy_id; one static config per
    # geometry keeps the JAX side to one compilation for all policies.
    cfg_j = cfg_j.with_(policy="hotness")
    jt, jsc, jbf = js.table, _j_scalars(js), js.bank_free
    tt, tsc, tbf = ts.table, _t_scalars(ts), ts.bank_free
    fired = {"swaps": 0, "retired": 0, "injected": 0}
    for c in range(len(arrays[0]) // cfg_j.chunk):
        sl = slice(c * cfg_j.chunk, (c + 1) * cfg_j.chunk)
        chunk = [a[sl] for a in arrays]
        jt, jsc, jbf, jo = jax_step(cfg_j, jreg, jt, jp, jsc, jbf,
                                    *map(jnp.asarray, chunk), jplan)
        tt, tsc, tbf, to = tcs.step_ref(cfg_t, treg, tt, tp, tsc, tbf,
                                        *map(T, chunk), tplan, seq=seq)
        where = f"{policy} seq={seq} chunk {c}"
        assert_same(jt, tt, f"{where} table")
        assert_same(jsc, tsc, f"{where} scalars")
        assert_same(jbf, tbf, f"{where} bank_free")
        assert_same(jo, to, f"{where} outs")
        fired["retired"] += int(to["retired"]) >= 0
        fired["injected"] += int(to["injected"].sum())
    fired["swaps"] = int(tsc.dma.swaps_done)
    return fired


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_step_ref_matches_jax_step_ref(policy, seq):
    fired = _run_steps(
        policy, seq,
        lambda *a: _jstep(*a, seq=seq))
    assert fired["retired"] > 0 and fired["injected"] > 0, fired


@pytest.mark.parametrize("resolver", ["dense", "segmented"])
def test_step_ref_without_faults_or_retirement(resolver):
    """The disabled path (endurance 0, empty plan) through both
    resolvers of the scan path."""
    cfg_j, cfg_t, js, arrays, _ = _scenario("hotness", endurance=0,
                                            resolver=resolver)
    jreg = jcore.PolicyRegistry.snapshot(POLICIES)
    jp = cfg_j.runtime()
    jt, jsc, jbf = js.table, _j_scalars(js), js.bank_free
    ts = t_state(js)
    tt, tsc, tbf = ts.table, _t_scalars(ts), ts.bank_free
    for c in range(len(arrays[0]) // cfg_j.chunk):
        sl = slice(c * cfg_j.chunk, (c + 1) * cfg_j.chunk)
        chunk = [a[sl] for a in arrays]
        jt, jsc, jbf, jo = _jstep(cfg_j, jreg, jt, jp, jsc, jbf,
                                  *map(jnp.asarray, chunk))
        tt, tsc, tbf, to = tcs.step_ref(cfg_t, PolicyRegistry.snapshot(),
                                        tt, t_params(jp), tsc, tbf,
                                        *map(T, chunk))
        assert_same((jt, jsc, jbf, jo), (tt, tsc, tbf, to), f"chunk {c}")


@pytest.mark.parametrize("policy", POLICIES)
def test_step_ref_seq_indices_stay_in_bounds(policy):
    """Out-of-range indices reach the plain step from every side: trace
    pages past the table and negative, fault deaths naming pages past the
    end, and a rescue register past the end. On the CPU an out-of-range
    PyTorch index raises, so this run shows that every advanced index of
    the plain step (the retire and policy phases included) is clamped or
    wrapped, and the results still equal JAX's bit for bit."""
    cfg_j, cfg_t, js, arrays, jplan = _scenario(policy, seed=3)
    n_pages = cfg_j.n_pages
    page = arrays[0].copy()
    page[::7] = n_pages + 5
    page[3::11] = -3
    page[5::13] = -n_pages - 9
    arrays = (page, *arrays[1:])
    deaths = np.asarray(jplan.deaths).copy()
    deaths[:, 1] = n_pages + np.arange(len(deaths))
    jplan = jplan._replace(deaths=jnp.asarray(deaths))
    js = js._replace(rescue_page=jnp.int32(n_pages + 1))
    jreg = jcore.PolicyRegistry.snapshot(POLICIES)
    jp = cfg_j.runtime()
    tp, tplan = t_params(jp), t_plan(jplan)
    ts = t_state(js)
    jt, jsc, jbf = js.table, _j_scalars(js), js.bank_free
    tt, tsc, tbf = ts.table, _t_scalars(ts), ts.bank_free
    for c in range(len(page) // cfg_j.chunk):
        sl = slice(c * cfg_j.chunk, (c + 1) * cfg_j.chunk)
        chunk = [a[sl] for a in arrays]
        jt, jsc, jbf, jo = _jstep(cfg_j.with_(policy="hotness"), jreg, jt,
                                  jp, jsc, jbf, *map(jnp.asarray, chunk),
                                  jplan, seq=True)
        tt, tsc, tbf, to = tcs.step_ref(cfg_t, PolicyRegistry.snapshot(),
                                        tt, tp, tsc, tbf, *map(T, chunk),
                                        tplan, seq=True)
        assert_same((jt, jsc, jbf, jo), (tt, tsc, tbf, to), f"chunk {c}")


def test_step_ref_matches_interpreted_pallas_kernel():
    """One run of the JAX one-kernel chunk step (interpret mode) against
    the plain version of the CUDA kernel."""
    def pallas_step(cfg, reg, *args):
        return jcs.chunk_step(cfg.with_(chunk_step_kernel="on"), reg, *args)
    fired = _run_steps("wear_level", True, pallas_step, n_chunks=2)
    assert fired["injected"] > 0


def test_packed_scalar_layout_matches_the_cuda_source():
    """The int/float vectors and the output scalars of the CUDA kernel use
    the same slot order as :func:`_pack_scalars` (enums in the .cu)."""
    src = (CSRC / "chunk_step.cu").read_text()

    def enum(name):
        body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
        names = [w.split("=")[0].strip() for w in body.split(",")]
        return [w.lower() for w in names if w]

    ints = enum("IntSlot")
    assert ints[-1] == "n_ints"
    assert tuple(ints[:-1]) == tcs.SC_FIELDS + tcs.INT_PARAM_FIELDS
    floats = enum("FloatSlot")
    assert tuple(floats[:-1]) == tcs.FLOAT_PARAM_ORDER
    assert "constexpr int N_STATE = FAULT_CURSOR + 1;" in src
    assert ints.index("fault_cursor") + 1 == len(tcs.SC_FIELDS) == 14
    assert tuple(enum("CounterInt")[:-1]) == tcs.COUNTER_INT_FIELDS
    assert tuple(enum("CounterFloat")[:-1]) == tcs.COUNTER_FLOAT_FIELDS
    assert len(tcs.COUNTER_INT_FIELDS) + len(tcs.COUNTER_FLOAT_FIELDS) == \
        len(tcore.counters.Counters._fields)
    assert tuple(c.removeprefix("co_") for c in enum("ChunkOut")[:-1]) == \
        tcs.CHUNK_OUT
    assert tuple(c.removeprefix("ph_") for c in enum("Phase")[:-1]) == \
        tcs.PHASES
    # The stage split is an instantiation of the one library (a non-null
    # ``phases`` picks it), not a second build.
    assert "template <bool WS, bool STAMPS>" in src
    assert "REPRO_PHASE_STAMPS" not in src
    assert "kernel_of(ws, phases != nullptr)" in src
    # The occupancy entry asks about the instantiation a launch takes.
    assert "kernel_of(!fits, stamped != 0)" in src
    assert f"constexpr int MAX_CLUSTER = {tcs.MAX_CLUSTER};" in src
    assert not hasattr(tcs, "KERNEL_STAMPED")
    assert set(tcs.KERNEL.entries) == {"chunk_step_launch",
                                       "chunk_step_layout",
                                       "chunk_step_clusters"}
    for entry in tcs.KERNEL.entries:
        assert f'extern "C" int {entry}(' in src
    pol = enum("Policy")
    assert tuple(p.removeprefix("p_") for p in pol) == POLICIES
    cs = tcore.small_platform()
    p = cs.runtime()
    sc = _t_scalars(tcore.init_state(cs, p))
    ints_v, floats_v = tcs._pack_scalars(p, sc)
    assert ints_v.dtype == torch.int32 and floats_v.dtype == torch.float32
    assert ints_v.shape == (29,) and floats_v.shape == (7,)
    assert int(ints_v[ints.index("policy_id")]) == int(p.policy_id)


# Clusters resident at each size on a card that holds 15 of 8 CTAs.
_RESIDENT = {8: 15, 6: 17, 4: 33, 2: 66, 1: 132}


@pytest.mark.parametrize("points,want", [
    (1, 8), (15, 8), (16, 6), (17, 6), (18, 4), (33, 4), (34, 2), (64, 2),
    (66, 2), (67, 1), (132, 1), (133, 1), (264, 1), (265, 1)])
def test_cluster_for_takes_the_fewest_waves(points, want):
    """Kernel B's CTAs a point: the size of the fewest waves, the largest
    of those; every launch that fits at 8 keeps 8."""
    assert tcs.cluster_for(points, _RESIDENT) == want


@pytest.mark.parametrize("resident,points,want", [
    ({8: 10, 7: 16, 6: 16, 5: 20, 1: 99}, 16, 7),   # 7 and 6 tie
    ({8: 15, 4: 30, 2: 31}, 40, 4),                  # 2 waves at 4 and 2
    ({8: 15, 6: 15}, 20, 8),                         # 2 waves at 8 and 6
    ({8: 0, 6: 17, 1: 132}, 3, 6),                   # 8 cannot run
    ({8: 15, 6: 15, 1: 132}, 20, 1)])
def test_cluster_for_breaks_ties_to_the_largest_size(resident, points, want):
    assert tcs.cluster_for(points, resident) == want


def test_cluster_for_against_every_size():
    """Against the rule spelled out, on a table of all eight sizes."""
    resident = {8: 15, 7: 16, 6: 17, 5: 22, 4: 33, 3: 44, 2: 66, 1: 132}
    for points in range(1, 400):
        w = {c: tcs.waves(points, n) for c, n in resident.items()}
        got = tcs.cluster_for(points, resident)
        assert w[got] == min(w.values())
        assert got == max(c for c in w if w[c] == w[got])
    with pytest.raises(RuntimeError, match="resident"):
        tcs.cluster_for(4, {8: 0, 1: 0})


def test_chunk_step_knob_on_cpu_tensors():
    cfg = tcore.small_platform()
    table = tcore.init_table(cfg)
    assert tcs.use_chunk_step_kernel(cfg, table) is False
    assert tcs.use_chunk_step_kernel(cfg.with_(chunk_step_kernel="off"),
                                     table) is False
    with pytest.raises(ValueError, match="CUDA"):
        tcs.use_chunk_step_kernel(cfg.with_(chunk_step_kernel="on"), table)
    with pytest.raises(ValueError, match="chunk_step_kernel"):
        tcs.use_chunk_step_kernel(cfg.with_(chunk_step_kernel="bogus"),
                                  table)
    with pytest.raises(ValueError, match="CUDA"):
        tcs.chunk_step_cuda(cfg, PolicyRegistry.snapshot(), table[None],
                            *([None] * 12))


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _to(device, x):
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    if isinstance(x, dict):
        return {k: _to(device, v) for k, v in x.items()}
    if type(x) is tuple:
        return tuple(_to(device, v) for v in x)
    return type(x)(*(_to(device, v) for v in x))


def kernels_against_plain(device):
    """Both CUDA kernels on ``device`` against their plain versions on
    the CPU: the gather at B = 2 with out-of-range pages, the chunk step
    for every policy over the fault scenario, after every chunk."""
    table, pages, _ = _lookup_case(1, b=2, n_pages=300, m=514)
    got = t_hl.hmmu_lookup(T(table).to(device), T(pages).to(device))
    assert torch.equal(got.cpu(), t_hl.hmmu_lookup_plain(T(table), T(pages)))
    treg = PolicyRegistry.snapshot()
    for policy in POLICIES:
        cfg_j, cfg_t, js, arrays, jplan = _scenario(policy)
        on = cfg_t.with_(chunk_step_kernel="on")
        ts = t_state(js)
        tp, tplan = t_params(cfg_j.runtime()), t_plan(jplan)
        plain = (ts.table.clone(), _t_scalars(ts), ts.bank_free.clone())
        card = _to(device, plain)
        kp, kplan = _to(device, tp), _to(device, tplan)
        for c in range(len(arrays[0]) // cfg_t.chunk):
            sl = slice(c * cfg_t.chunk, (c + 1) * cfg_t.chunk)
            chunk = [T(a[sl]) for a in arrays]
            *plain, po = tcs.step_ref(cfg_t, treg, *plain[:1], tp, plain[1],
                                      plain[2], *chunk, tplan, seq=True)
            *card, ko = tcs.chunk_step(on, treg, card[0], kp, card[1],
                                       card[2], *_to(device, tuple(chunk)),
                                       kplan)
            assert_same((plain, po), _to("cpu", (tuple(card), ko)),
                        f"{policy} chunk {c}")


@pytest.mark.cuda
def test_cuda_kernels_equal_their_plain_versions(cuda_device):
    kernels_against_plain(cuda_device)
