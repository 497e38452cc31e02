"""The chunk-step, attention and RWKV CUDA kernels against their plain
versions.

These tests need a CUDA card (the kernels have no CPU mode): they are
marked ``cuda`` and skip elsewhere. The file imports neither ``jax`` nor
``repro``, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The chunk-step kernel runs a whole trace in one launch and is held bit
for bit against its plain version (the loop of ``step_ref(seq=True)``
and ``counters.update``). Each model-kernel case goes through the port's
entry point (``ops.*``), checks that the kernel was launched exactly
once, and compares with the plain version on the same card within
``ref.kernel_error``'s allowance, the one ``chip_smoke.py`` holds the
kernels to at full width.
"""
import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch
import repro_torch.core as tcore
from repro_torch import telemetry
from repro_torch.core import emulator as t_emu, table as t_table
from repro_torch.core.policies import PolicyRegistry
from repro_torch.kernels import chunk_step as t_cs
from repro_torch.kernels import decode_attention as t_da
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import rwkv_scan as t_rw

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(seed, dev, dtype, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev, dtype) for s in shapes]


def _within(kind, got, want):
    err, share = t_ref.kernel_error(kind, got, want)
    assert share <= 1.0, f"max|err| {err:.3e} is {share:.2f} of its allowance"


def _once(kernel, fn):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
def test_fused_lookup_kernel_equals_plain_at_16_points(cuda_device, shared):
    """Kernel A's fused entry over 16 points x (512 + 2) rows, each point
    from its own table, with negative and past-the-end pages and raw DMA
    registers (-1 idle, negative, past the end), in ONE launch, against
    its plain version bit for bit; ``shared`` gives every point one chunk
    as an expanded view (point stride 0)."""
    from repro_torch.kernels import hmmu_lookup as t_hl
    rng = np.random.default_rng(16)
    b, n_pages, m = 16, 4099, 512
    table = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, (b, n_pages, 8))
                             .astype(np.int32)).to(cuda_device)
    pages = rng.integers(-5, n_pages + 5, (1 if shared else b, m))
    pages[:, :3] = [-1, n_pages, 2 ** 30]
    pages = torch.from_numpy(pages.astype(np.int32)).to(cuda_device)
    pages = pages.expand(b, -1)
    regs = torch.from_numpy(rng.integers(-3, n_pages + 3, (2, b))
                            .astype(np.int32)).to(cuda_device)
    regs[:, 0] = torch.tensor([-1, n_pages], dtype=torch.int32)
    page_a, page_b = regs[0], regs[1]
    got = _once(t_hl.KERNEL, lambda: t_ops.hmmu_lookup_fused(
        table, pages, page_a, page_b))
    want = t_ref.hmmu_lookup_fused(table, pages, page_a, page_b)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_equals_plain(cuda_device, dtype):
    for sq, skv, d, window in ((128, 128, 64, None), (64, 256, 96, 80),
                               (256, 256, 256, 100), (32, 32, 8, None)):
        q, k, v = _normal(8, cuda_device, DTYPES[dtype], (2, 4, sq, d),
                          (2, 2, skv, d), (2, 2, skv, d))
        got = _once(t_fa.KERNEL,
                    lambda: t_ops.flash_attention(q, k, v, window=window))
        _within("attention", got,
                t_fa.flash_attention_plain(q, k, v, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_equals_plain(cuda_device, dtype):
    for hq, hkv, d, window in ((8, 2, 128, None), (32, 1, 64, 100),
                               (4, 4, 256, 64)):
        q, kc, vc = _normal(9, cuda_device, DTYPES[dtype], (3, hq, d),
                            (3, hkv, 1024, d), (3, hkv, 1024, d))
        lens = torch.tensor([1, 500, 1024], dtype=torch.int32,
                            device=cuda_device)
        got = _once(t_da.KERNEL, lambda: t_ops.decode_attention(
            q, kc, vc, lens, window=window))
        _within("attention", got, t_da.decode_attention_plain(
            q, kc, vc, lens, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_kernel_equals_plain(cuda_device, dtype):
    """Chunks 8, 16, 32 and 128 (padded to 16 rows where they are not a
    multiple), widths 16, 24, 32 and 64, key and value widths apart (32 and
    64), one chunk alone (S 64 and 24 under chunks 128 and 32: no chunk
    state launch, the state scan writes S_0 = 0 only), and 32 chunks of
    128 at B 2 with rwkv6-7b's decay on its slowest- and fastest-decaying
    heads."""
    for b, chunk, s, d, dv, decay in ((1, 8, 64, 16, 16, "normal"),
                                      (1, 128, 512, 64, 64, "normal"),
                                      (1, 32, 96, 32, 32, "normal"),
                                      (1, 16, 48, 24, 24, "normal"),
                                      (1, 32, 96, 32, 64, "normal"),
                                      (1, 128, 64, 64, 64, "normal"),
                                      (1, 32, 24, 16, 16, "normal"),
                                      (2, 128, 4096, 64, 64, "model")):
        rng = np.random.default_rng(10)
        r, k, v = _normal(11, cuda_device, DTYPES[dtype], (b, 4, s, d),
                          (b, 4, s, d), (b, 4, s, dv))
        if decay == "model":     # -exp(linspace(-6, -1) + N(0, 0.5^2))
            base = np.linspace(-6.0, -1.0, 64 * d).reshape(64, 1, d)
            lw = -np.exp(base[[0, 1, 62, 63]][None]
                         + 0.5 * rng.standard_normal((b, 4, s, d)))
        else:
            lw = -np.exp(rng.standard_normal((b, 4, s, d)) - 1.5)
        logw = torch.from_numpy(lw.astype(np.float32))
        logw = logw.to(cuda_device, DTYPES[dtype])
        u = torch.from_numpy((rng.standard_normal((4, d)) * 0.3)
                             .astype(np.float32)).to(cuda_device)
        got = _once(t_rw.KERNEL,
                    lambda: t_ops.rwkv_chunk(r, k, v, logw, u, chunk=chunk))
        _within("rwkv", got, t_rw.rwkv_scan_plain(r, k, v, logw, u, chunk)[0])


@pytest.mark.cuda
def test_rwkv_chunk_past_shared_memory_raises(cuda_device):
    """Chunk 192 at width 128 needs ~304 KB of shared memory in the output
    launch: the wrapper refuses it by name before the launch."""
    r = torch.zeros((1, 1, 192, 128), device=cuda_device)
    u = torch.zeros((1, 128), device=cuda_device)
    before = t_rw.KERNEL.launches
    with pytest.raises(ValueError, match="shared memory"):
        t_rw.rwkv_chunk_scan_cuda(r, r, r, r, u, chunk=192)
    assert t_rw.KERNEL.launches == before


# Causal prefill, a continuation (Sq < Skv) with and without a window, a
# window over several kv tiles, a ragged 32-row sequence, and non-causal
# (b, hq, hkv, sq, skv, causal, window); GQA 2:1 and 4:1 among them.
FLASH_SHAPES = ((2, 4, 2, 256, 256, True, None),
                (1, 4, 1, 128, 384, True, None),
                (2, 4, 2, 128, 512, True, 200),
                (1, 2, 2, 512, 512, True, 96),
                (2, 2, 1, 32, 32, True, None),
                (1, 2, 1, 256, 256, False, 64))


def _flash_path(dev, dtype, d, variant):
    """Every FLASH_SHAPES call at head dim d reports ``variant`` and stays
    within the allowance."""
    for b, hq, hkv, sq, skv, causal, window in FLASH_SHAPES:
        q, k, v = _normal(12, dev, dtype, (b, hq, sq, d), (b, hkv, skv, d),
                          (b, hkv, skv, d))
        before = t_fa.KERNEL.variant_launches[variant]
        got = _once(t_fa.KERNEL, lambda: t_ops.flash_attention(
            q, k, v, causal=causal, window=window))
        assert t_fa.KERNEL.variant_launches[variant] == before + 1
        _within("attention", got, t_fa.flash_attention_plain(
            q, k, v, causal=causal, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256, 32, 80, 96])
def test_flash_attention_bf16_takes_the_wgmma_path(cuda_device, d):
    """bf16 at head dims that are a multiple of 8, on the wgmma path built
    for 64, 128 or 256 (at 32, 80 and 96 the columns past D read as
    zeros): every call of FLASH_SHAPES reports "wgmma"."""
    _flash_path(cuda_device, torch.bfloat16, d, "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("float32", 8), ("float32", 20),
                                     ("float32", 64), ("float32", 96),
                                     ("float32", 128), ("float32", 256),
                                     ("bfloat16", 20), ("bfloat16", 100)])
def test_flash_attention_takes_the_mma_path(cuda_device, dtype, d):
    """fp32 at any head dim, and bf16 at one that is not a multiple of 8,
    on the mma path (3xTF32 on the TF32 tensor cores; D 20 and 100 pad
    to 32 and 128, D 20 in fp32 copies 4 bytes at a time): every call of
    FLASH_SHAPES reports "mma"."""
    _flash_path(cuda_device, DTYPES[dtype], d, "mma")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_across_splits(cuda_device, dtype):
    """kv_len 1, on and around split boundaries and across many splits,
    and a window that crosses split boundaries; kv_len 0 gives 0."""
    from repro_torch.kernels.decode_attention import split_plan
    b, hq, hkv, smax, d = 6, 8, 2, 4096, 128
    for window in (None, 300):
        _, length = split_plan(b, hkv, smax, window)
        lens = torch.tensor([0, 1, length, length + 1, 5 * length + 7, smax],
                            dtype=torch.int32, device=cuda_device)
        q, kc, vc = _normal(13, cuda_device, DTYPES[dtype], (b, hq, d),
                            (b, hkv, smax, d), (b, hkv, smax, d))
        got = _once(t_da.KERNEL, lambda: t_ops.decode_attention(
            q, kc, vc, lens, window=window))
        assert not got[0].any()
        _within("attention", got[1:], t_da.decode_attention_plain(
            q, kc, vc, lens, window=window)[1:])


# ------------------------------------------------------------ chunk step
POLICIES = ("static", "hotness", "write_bias", "stream", "hotness_global",
            "wear_level")


def _chunk_scenario(dev, policy, n_chunks=11, seed=0, slow="3dxpoint"):
    """small_platform(chunk=16) from an adversarial state (pins, a
    poisoned page, a swap in flight), a few pages out of range, endurance
    retirement on, and a fault plan of deaths and transients; ``slow``
    names the slow tier's technology."""
    cfg = tcore.small_platform(chunk=16, policy=policy, hot_threshold=2,
                               decay_every=4, endurance_budget=6,
                               write_weight=3,
                               slow=tcore.TECHNOLOGIES[slow])
    params = cfg.runtime(dev)
    st = tcore.init_state(cfg, params)
    nf = cfg.n_fast_pages
    tab = t_table.set_flags(st.table, [0, 1], t_table.PIN_FAST)
    tab = t_table.set_flags(tab, [nf + 1], t_table.PIN_SLOW)
    tab = t_table.set_flags(tab, [nf + 3], t_table.POISONED)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)
    st = st._replace(table=tab, dma=st.dma._replace(
        active=i32(1), page_a=i32(nf + 2), page_b=i32(nf - 1),
        start=i32(0)))
    rng = np.random.default_rng(seed)
    n = n_chunks * cfg.chunk
    page = np.where(rng.random(n) < 0.5, nf + rng.integers(0, 8, n),
                    rng.integers(0, cfg.n_pages, n)).astype(np.int32)
    page[rng.random(n) < 0.15] = nf + 2
    page[rng.random(n) < 0.03] = cfg.n_pages + 3    # JAX's gather rules
    page[rng.random(n) < 0.03] = -2
    off = (rng.integers(0, cfg.page_size // 64, n) * 64).astype(np.int32)
    trace = tcore.Trace(*(torch.as_tensor(x, device=dev) for x in (
        page, off, rng.random(n) < 0.5, np.full(n, 64, np.int32))))
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[-5:] = False
    plan = tcore.seeded_plan(seed, pages=np.arange(nf, nf + 12),
                             n_chunks=n_chunks, n_deaths=2, n_transient=8,
                             device=dev)
    return cfg, params, st, trace, valid, plan


def _leaves(x):
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _leaves(x[k])]
    if isinstance(x, tuple):
        return [y for v in x for y in _leaves(v)]
    return [x]


def _assert_equal(got, want):
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_chunk_step_one_launch_equals_the_plain_loop(cuda_device, policy):
    """Every chunk in ONE launch against the plain per-chunk loop: final
    state (table, scalars, bank registers, the 16 counters) and every
    output, with deaths, transients and retirements firing."""
    cfg, params, st, trace, valid, plan = _chunk_scenario(cuda_device,
                                                          policy)
    reg = PolicyRegistry.snapshot()
    before = t_cs.KERNEL.launches
    got = t_emu._emulate_impl(cfg.with_(chunk_step_kernel="on"), reg, trace,
                              valid, t_emu.clone_state(st), params, plan)
    torch.cuda.synchronize()
    assert t_cs.KERNEL.launches == before + 1
    want = t_emu._emulate_impl(cfg, reg, trace, valid, t_emu.clone_state(st),
                               params, plan, seq=True)
    _assert_equal(got, want)
    assert int((want[1]["retired_page"] >= 0).sum()) > 0
    assert int(want[0].counters.transient_faults) > 0


def _read_sums(cfg, trace, valid, latency):
    """Each chunk's integer sum of its read latencies."""
    reads = (~trace.is_write & valid).reshape(-1, cfg.chunk)
    lat = latency.reshape(-1, cfg.chunk).to(torch.int64)
    return torch.where(reads, lat, 0).sum(dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_chunk_step_counters_exact_past_2_24(cuda_device, policy):
    """A slow tier of hard disks: a chunk's read latencies sum past 2^24,
    where float32 sums in different orders differ; the kernel's counter
    fold equals the plain loop's (each chunk's exact sum rounded once)
    bit for bit."""
    cfg, params, st, trace, valid, plan = _chunk_scenario(cuda_device,
                                                          policy, slow="hdd")
    reg = PolicyRegistry.snapshot()
    got = t_emu._emulate_impl(cfg.with_(chunk_step_kernel="on"), reg, trace,
                              valid, t_emu.clone_state(st), params, plan)
    want = t_emu._emulate_impl(cfg, reg, trace, valid, t_emu.clone_state(st),
                               params, plan, seq=True)
    assert int(_read_sums(cfg, trace, valid,
                          want[1]["latency"]).max()) > 2 ** 24
    _assert_equal(got, want)


@pytest.mark.cuda
def test_engine_run_launches_once_and_updates_the_state_in_place(
        cuda_device):
    """``Engine.run`` on "auto": one launch of the chunk-step kernel per
    run (a padded trace of 13 chunks), the passed state's own memory
    updated (the returned state is new objects over it; the passed one
    is consumed), and the same results as the CPU loop."""
    cfg = tcore.small_platform(chunk=16, hot_threshold=2)
    rng = np.random.default_rng(1)
    n = 200
    arrays = (rng.integers(0, cfg.n_pages, n).astype(np.int32),
              (rng.integers(0, cfg.page_size // 64, n) * 64).astype(np.int32),
              rng.random(n) < 0.4, np.full(n, 64, np.int32))
    eng = repro_torch.Engine(cfg)
    cpu = repro_torch.Engine(cfg, device="cpu")
    state = eng.init_state()
    ptrs = [t.data_ptr() for t in _leaves(state)]
    before = t_cs.KERNEL.launches
    trace = tcore.Trace(*(torch.as_tensor(a, device=cuda_device)
                          for a in arrays))
    first = state
    for _ in range(2):   # the second run continues from the first's state
        res = eng.run(trace, state=state)
        state = res.state
    torch.cuda.synchronize()
    assert t_cs.KERNEL.launches == before + 2
    assert [t.data_ptr() for t in _leaves(res.state)] == ptrs
    with pytest.raises(RuntimeError, match="consumed"):
        eng.run(trace, state=first)
    trace = tcore.Trace(*(torch.as_tensor(a) for a in arrays))
    ref = cpu.run(trace)
    ref = cpu.run(trace, state=ref.state)
    _assert_equal(tuple(t.cpu() for t in _leaves(res)), tuple(_leaves(ref)))


# ------------------------------------------------------------ the sweep
def _stack(states):
    """Point states stacked along a leading point axis."""
    if isinstance(states[0], tuple):
        return type(states[0])(*(_stack(xs) for xs in zip(*states)))
    return torch.stack(states)


def _point(stacked, i):
    """Design point ``i`` of a stacked state or of stacked outputs."""
    if isinstance(stacked, dict):
        return {k: v[i] for k, v in stacked.items()}
    return t_emu._index(stacked, i)


@pytest.mark.cuda
def test_sweep_is_one_launch_and_each_point_equals_its_run(cuda_device):
    """A 24-point grid (policies not in built-in order, two fast-tier
    splits, two slow tiers, two link latencies) under a shared fault plan
    with endurance retirement: ONE chunk-step launch, no lookup launch,
    and every point bitwise equal to its own ``Engine.run``."""
    from repro_torch.kernels import hmmu_lookup as t_hl
    from repro_torch.sweep import SweepSpec, build_points
    cfg, _, _, trace, _, plan = _chunk_scenario(cuda_device, "hotness")
    spec = SweepSpec(cfg, technologies=("3dxpoint", "stt-ram"),
                     fast_fractions=(0.125, 0.25),
                     policies=("wear_level", "hotness", "static"),
                     link_lats=(40, 600))
    eng = repro_torch.Engine(cfg)
    before = (t_cs.KERNEL.launches, t_hl.KERNEL.launches)
    res = eng.sweep(spec, trace, faults=plan)
    torch.cuda.synchronize()
    assert (t_cs.KERNEL.launches, t_hl.KERNEL.launches) == \
        (before[0] + 1, before[1])
    for i, p in enumerate(build_points(spec)):
        want = eng.run(trace, params=p.params(cuda_device), faults=plan)
        _assert_equal((_point(res.states, i), _point(res.outs, i)),
                      tuple(want))
    assert int(res.states.counters.frames_retired.sum()) > 0


@pytest.mark.cuda
def test_sweep_registry_subset_and_out_of_range_id_equal_the_plain_run(
        cuda_device):
    """A registry subset not in built-in order, and a ``policy_id`` past
    its end (the clamped policy, ``write_bias``, without its write
    weighting), in one launch: each point equal to the plain loop
    (``step_ref(seq=True)``) at the same registry and id."""
    cfg, params, st, trace, valid, plan = _chunk_scenario(cuda_device,
                                                          "write_bias")
    eng = repro_torch.Engine(cfg, registry=("wear_level", "hotness",
                                            "write_bias"))
    ids = (0, 1, 2, 7)
    stacked = tcore.RuntimeParams(*(x.expand(len(ids)).contiguous()
                                    for x in params))._replace(
        policy_id=torch.tensor(ids, dtype=torch.int32, device=cuda_device))
    res = eng.sweep(stacked, trace, faults=plan,
                    states=_stack([st] * len(ids)))
    padded = torch.ones_like(valid)   # sweep pads: every request valid
    for i in range(len(ids)):
        p = params._replace(policy_id=stacked.policy_id[i])
        want = t_emu._emulate_impl(cfg, eng.registry, trace, padded,
                                   t_emu.clone_state(st), p, plan, seq=True)
        _assert_equal((_point(res.states, i), _point(res.outs, i)), want)
    assert not torch.equal(res.states.table[2], res.states.table[3])


# ------------------------------------------------- CTAs a design point
def _grid(cfg, params, points):
    """``points`` copies of ``params`` stacked, each a built-in policy in
    turn (``hotness_global`` among every six) and its own
    ``hot_threshold`` from each group of six on."""
    k = torch.arange(points, dtype=torch.int32, device=params.policy_id.device)
    return tcore.RuntimeParams(*(x.expand(points).contiguous()
                                 for x in params))._replace(
        policy_id=k % len(POLICIES), hot_threshold=2 + k // len(POLICIES) % 3)


def _cluster_case(dev, geometry, points):
    """(engine, a sweep of ``points`` points, the cluster-8 launch): on
    ``_chunk_scenario``'s small platform from its adversarial state under
    its fault plan, or on the paper's table (294,912 rows) with a fresh
    state; decay every 4 chunks in both."""
    if geometry == "small":
        cfg, params, st, trace, _, plan = _chunk_scenario(dev,
                                                          "hotness_global")
        eng = repro_torch.Engine(cfg)
        grid = _grid(cfg, params, points)

        def sweep():
            return eng.sweep(grid, trace, faults=plan,
                             states=_stack([st] * points))
    else:
        cfg = tcore.paper_platform().with_(chunk=512, decay_every=4)
        trace = _paper_trace(cfg, 24 * 512 - 7, 2, dev)
        eng = repro_torch.Engine(cfg)
        grid = _grid(cfg, cfg.runtime(dev), points)

        def sweep():
            return eng.sweep(grid, trace)
    return eng, sweep


@pytest.mark.cuda
@pytest.mark.parametrize("geometry,points", [
    *(("small", b) for b in (1, 15, 16, 17, 31, 64)),
    ("paper", 16), ("paper", 64)])
def test_chosen_cluster_equals_clusters_of_eight(cuda_device, monkeypatch,
                                                 geometry, points):
    """The launch's own CTAs a point against clusters of 8 over every
    policy, decay chunks and (small) deaths, transients and retirements:
    table, scalars, outputs and counters bit for bit. Under a profiler the
    span reports the fewest waves the card's resident clusters allow, at
    the largest size that gives them: 8 wherever the points fit at 8."""
    eng, sweep = _cluster_case(cuda_device, geometry, points)
    chosen = sweep()
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        traced = sweep()
        torch.cuda.synchronize()
    (enq,) = [s for s in telemetry.recorded().spans
              if s.name == "chunk_step.enqueue"]
    monkeypatch.setattr(t_cs, "chunk_step_cuda", functools.partial(
        t_cs.chunk_step_cuda, cluster=8))
    eight = sweep()
    monkeypatch.undo()
    for got in (chosen, traced):
        _assert_equal((got.states, got.outs), (eight.states, eight.outs))
    assert int(eight.states.dma.swaps_done.sum()) > 0
    resident = t_cs.resident_clusters(str(chosen.states.table.device),
                                      eng.cfg.chunk, eng.cfg.n_banks, True)
    fewest = min(t_cs.waves(points, n) for n in resident.values() if n)
    want = max(c for c, n in resident.items()
               if n and t_cs.waves(points, n) == fewest)
    assert (enq.attrs["cluster"], enq.attrs["waves"],
            enq.attrs["resident"]) == (want, fewest, resident[want])
    assert (want == 8) == (points <= resident[8])


# ------------------------------------------------------------------ serving
def _serve_run(cfg, device, plan, **kw):
    """tests/test_serve.py's ServeConfig on ``cfg``, with a fault plan."""
    from repro_torch.kernels import hmmu_lookup as t_hl
    from repro_torch.serve import ContinuousBatchingScheduler, ServeConfig
    sched = ContinuousBatchingScheduler(
        repro_torch.Engine(cfg, device=device), ServeConfig(
            sorted_batch_sizes=(32, 64, 128), max_live_seqs=100,
            max_admit_per_step=32, max_pages_per_seq=6, positions_per_page=8,
            window_pages=2, prefill_writes_per_page=2, record_traces=True,
            faults=plan, **kw))
    sched.warmup()
    rng = np.random.default_rng(1)
    sched.submit(rng.integers(1, 4, 150), rng.integers(1, 16, 150))
    before = (t_cs.KERNEL.launches, t_hl.KERNEL.launches)
    c0 = sched.engine.compile_count
    sched.run()
    if device != "cpu":
        torch.cuda.synchronize()
    launches = (t_cs.KERNEL.launches - before[0],
                t_hl.KERNEL.launches - before[1])
    return sched, launches, sched.engine.compile_count - c0


@pytest.mark.cuda
@pytest.mark.parametrize("max_live_batches", [1, 3])
@pytest.mark.parametrize("route", ["auto", "off"])
def test_serve_scheduler_on_the_card_equals_the_cpu_port(
        cuda_device, route, max_live_batches):
    """The small-platform scheduler (pins, evictions, a fault plan whose
    deaths cross dispatches) on the card against the same scheduler on
    the CPU: report, dispatch and trace logs, every output, the final
    state and the KV map; on ``"auto"`` one chunk-step launch a dispatch,
    on ``"off"`` one lookup launch a chunk; no new dispatch key."""
    cfg = tcore.small_platform(n_fast_pages=64, n_slow_pages=448, chunk=32,
                               chunk_step_kernel=route)
    plan = dict(seed=5, pages=np.arange(64), n_chunks=100, n_deaths=12,
                n_transient=20)
    got, launches, new_keys = _serve_run(
        cfg, cuda_device, tcore.seeded_plan(**plan),
        max_live_batches=max_live_batches)
    want, _, _ = _serve_run(cfg, "cpu", tcore.seeded_plan(**plan),
                            max_live_batches=max_live_batches)
    a, b = got.report().to_dict(), want.report().to_dict()
    a.pop("compile_count"), b.pop("compile_count")
    assert a == b and a["frames_retired"] > 0
    assert new_keys == 0
    assert got.dispatch_log == want.dispatch_log
    for x, y in zip(got.trace_log, want.trace_log, strict=True):
        _assert_equal(tuple(x), tuple(y))
    for x, y in zip(got.outs_log, want.outs_log, strict=True):
        assert list(x) == list(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
    _assert_equal(tuple(t.cpu() for t in _leaves(got.carry)),
                  tuple(_leaves(want.carry)))
    for f in ("page_of", "owner", "pinned", "dead", "last_access"):
        assert np.array_equal(getattr(got.kv, f), getattr(want.kv, f))
    n_dispatch = len(got.dispatch_log)
    n_chunks = sum(s for s, _ in got.dispatch_log) // cfg.chunk
    assert launches == ((n_dispatch, 0) if route == "auto"
                        else (0, n_chunks))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [None, 40])
def test_serve_contracts_on_the_card_equal_the_cpu(cuda_device, width):
    """Stamp and release a padded batch holding both pages of the DMA's
    in-flight swap, a poisoned and a retired page, page 0 (every padding
    lane's row) and the last page, on the card with no host
    synchronisation, against the same edits on the CPU."""
    from repro_torch.serve import release_pin_pages, stamp_pin_pages
    cfg = tcore.small_platform(n_fast_pages=64, n_slow_pages=448)
    nf, n = cfg.n_fast_pages, cfg.n_pages
    pages = np.array([nf + 9, 3, nf + 5, 7, 0, n - 1, 12, nf + 40, 3],
                     np.int32)
    states = []
    for dev in ("cpu", cuda_device):
        st = repro_torch.Engine(cfg, device=dev).init_state()
        tab = t_table.set_flags(st.table, [nf + 5], t_table.POISONED)
        tab = t_table.set_flags(tab, [7], t_table.POISONED | t_table.RETIRED)
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
        st = st._replace(table=tab, dma=st.dma._replace(
            active=i32(1), page_a=i32(nf + 9), page_b=i32(3)))
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            st = stamp_pin_pages(st, pages, width=width)
            stamped = st.table.clone()
            st = release_pin_pages(st, pages[:4], width=width)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        states.append((stamped.cpu(), st.table.cpu()))
    (cpu_s, cpu_r), (gpu_s, gpu_r) = states
    assert torch.equal(cpu_s, gpu_s) and torch.equal(cpu_r, gpu_r)
    fl = cpu_s[:, t_table.FLAGS]
    assert fl[nf + 9] & t_table.PIN_FAST and fl[3] & t_table.PIN_SLOW
    assert not fl[nf + 5] & t_table.PINNED and not fl[7] & t_table.PINNED
    assert fl[0] & t_table.PIN_FAST and fl[n - 1] & t_table.PIN_SLOW
    assert not (cpu_r[[nf + 9, 3], t_table.FLAGS] & t_table.PINNED).any()


# ------------------------------------------------- user policies, memtier
@pytest.fixture
def user_write_hot():
    """A user policy (the hottest slow page written in the chunk, the
    CLOCK victim) registered in the port; the module dict restored
    after."""
    from repro_torch.core import policies as pol
    from repro_torch.core.indexing import take_lane
    saved = dict(pol.POLICIES)

    def user_write_hot(cfg, params, table, ptr, pages, is_write, valid):
        cand, heat = pol._chunk_candidate(table, pages, valid,
                                          extra_mask=is_write)
        victim, vfound, skip = pol._clock_victim(table, ptr,
                                                 params.n_fast_pages)
        want = vfound & (heat >= params.hot_threshold) & \
            (heat > take_lane(table, victim, t_table.HOTNESS))
        new_ptr = (ptr + skip + want.to(torch.int32)) % params.n_fast_pages
        return want, cand, victim, new_ptr
    pol.register("user_write_hot")(user_write_hot)
    yield user_write_hot
    pol.POLICIES.clear()
    pol.POLICIES.update(saved)


def _small_trace(cfg, n, seed, dev):
    rng = np.random.default_rng(seed)
    page = np.where(rng.random(n) < 0.5,
                    cfg.n_fast_pages + rng.integers(0, 4, n),
                    rng.integers(0, cfg.n_pages, n)).astype(np.int32)
    arrays = (page, np.zeros(n, np.int32), rng.random(n) < 0.5,
              np.full(n, 64, np.int32))
    return tcore.Trace(*(torch.from_numpy(a).to(dev) for a in arrays))


@pytest.mark.cuda
def test_kernel_route_refuses_a_user_policy_by_name(cuda_device,
                                                    user_write_hot):
    """On the card, ``"auto"`` refuses a selected user policy by name
    before any launch; an unselected one still launches kernel B once;
    ``"off"`` runs the user policy equal to the CPU."""
    cfg = tcore.small_platform(chunk=16, hot_threshold=2,
                               policy="user_write_hot")
    trace = _small_trace(cfg, 96, 2, cuda_device)
    t_cs.KERNEL.reset()
    with pytest.raises(ValueError, match="'user_write_hot'.*\"off\""):
        repro_torch.Engine(cfg).run(trace)
    assert t_cs.KERNEL.launches == 0
    hot = repro_torch.Engine(cfg.with_(policy="hotness"))
    assert "user_write_hot" in hot.registry
    hot.run(trace)
    torch.cuda.synchronize()
    assert t_cs.KERNEL.launches == 1
    off = repro_torch.Engine(cfg.with_(chunk_step_kernel="off")).run(trace)
    cpu = repro_torch.Engine(cfg, device="cpu").run(trace.to("cpu"))
    assert int(cpu.state.dma.swaps_done) > 0
    for a, b in zip(t_emu._tensors(off.state), t_emu._tensors(cpu.state)):
        assert torch.equal(a.cpu(), b)
    for k in cpu.outs:
        assert torch.equal(off.outs[k].cpu(), cpu.outs[k])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["auto", "off"])
def test_tiered_accounting_on_the_card_equals_the_cpu(cuda_device, route):
    """``TieredKVAccounting`` on the card (kernel B a step, or the scan
    path) equals the CPU: report, table, pins; and a consumed state is
    refused on the card."""
    from repro_torch.memtier import TieredKVAccounting
    cfg = tcore.EmulatorConfig(n_fast_pages=16, n_slow_pages=112, chunk=16,
                               policy="hotness", hot_threshold=2,
                               chunk_step_kernel=route)
    tiers = [TieredKVAccounting(cfg, n_layers=2, positions_per_page=8,
                                bytes_per_position=256, device=d)
             for d in (cuda_device, "cpu")]
    for step in range(6):
        for tier in tiers:
            tier.account(tier.access_trace([0, 1, 2, 3],
                                           [20 + 3 * step] * 4))
        if step == 3:
            for tier in tiers:
                tier.free_sequence(1)
    card, cpu = tiers
    assert card.report() == cpu.report()
    assert torch.equal(card.state.table.cpu(), cpu.state.table)
    assert card._pinned == cpu._pinned
    stale = card.state
    card.account(card.access_trace([0], [40]))
    with pytest.raises(RuntimeError, match="consumed"):
        card.engine.run(card.access_trace([0], [41]), state=stale)


DENSE = ["minitron_8b", "phi3_mini_3p8b", "gemma3_4b", "internlm2_1p8b",
         "phi3_vision_4p2b", "musicgen_medium"]


def _close(got, want, rel=1e-5):
    got, want = got.float().cpu(), want.float().cpu()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rel * scale


FAMILIES = ["deepseek_v2_236b", "rwkv6_7b", "hymba_1p5b", "phi35_moe_42b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_dense_model_on_the_card_equals_the_cpu(cuda_device, arch):
    """The ten smoke configurations (float32; MLA, MoE, RWKV6 and Hymba
    too): ``forward_seq``, ``prefill`` and teacher-forced ``decode_step``
    on the card against the port on the CPU, same parameters, within 1e-5
    of each tensor's largest magnitude (every cache leaf; MoE routing
    must agree for that)."""
    from repro_torch import configs
    _dense_card_vs_cpu(cuda_device, configs.get_smoke(arch), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", DENSE)
def test_dense_model_bf16_on_the_card_equals_the_cpu(cuda_device, arch):
    """The same in bfloat16, under PyTorch's default
    ``allow_bf16_reduced_precision_reduction`` (on), which the model's
    entry points switch off for their own run and restore: within 2^-6 of
    each tensor's largest magnitude (a few bfloat16 steps of drift over
    two layers, the tolerance the CPU tests hold the port to JAX with)."""
    from repro_torch import configs
    mm = torch.backends.cuda.matmul
    assert mm.allow_bf16_reduced_precision_reduction
    cfg = configs.get_smoke(arch).with_(param_dtype="bfloat16",
                                        activation_dtype="bfloat16")
    _dense_card_vs_cpu(cuda_device, cfg, 2.0 ** -6)
    assert mm.allow_bf16_reduced_precision_reduction


def _dense_card_vs_cpu(cuda_device, cfg, rel):
    from repro_torch.models import ShardCtx, transformer as tt
    sh = ShardCtx()
    cpu = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = _to(cpu, cuda_device)
    rng = np.random.default_rng(2)
    shape = (2, 12, cfg.frame_dim) if cfg.frontend == "frames" else (2, 12)
    prompt = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              if cfg.frontend == "frames" else
              torch.from_numpy(rng.integers(0, cfg.vocab, shape)))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 2)))
    out = []
    for dev, params in (("cpu", cpu), (cuda_device, card)):
        x, _, _ = tt.forward_seq(cfg, params, prompt.to(dev), sh,
                                 collect_cache=False)
        logits, cache, pos = tt.prefill(cfg, params, prompt.to(dev), sh, 20)
        steps = [logits]
        for t in toks:
            lg, cache, pos = tt.decode_step(cfg, params, t.to(dev), cache,
                                            pos, sh)
            steps.append(lg)
        out.append((x, steps, cache))
    (cx, csteps, ccache), (x, steps, cache) = out
    _close(cx, x, rel)
    for a, b in zip(csteps, steps):
        _close(a, b, rel)
    for a, b in zip(_leaves(ccache), _leaves(cache)):
        _close(a, b, rel)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.cuda
def test_serve_engine_idle_lane_on_the_card_equals_the_cpu(cuda_device):
    """``ServeEngine`` on the card and on the CPU (gemma3-4b's smoke shape,
    float32, one idle lane run past ``smax``): no device assert, the same
    tokens wherever the CPU's rows have a clear top-2 margin (every row
    here), and the same report."""
    from repro_torch import configs
    from repro_torch.memtier import ServeEngine
    from repro_torch.memtier.engine import Request
    from repro_torch.models import init_params
    cfg = configs.get_smoke("gemma3_4b")
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (12, 36)]
    emu = tcore.EmulatorConfig(n_fast_pages=4, n_slow_pages=128, chunk=16,
                               policy="hotness", hot_threshold=2)
    runs = []
    for dev in ("cpu", cuda_device):
        eng = ServeEngine(cfg, _to(params, dev), batch_size=2, smax=40,
                          emu_cfg=emu, device=dev)
        rows = []
        decode = eng._decode

        def rec(*a, decode=decode, rows=rows, eng=eng):
            out = decode(*a)
            live = [i for i, r in enumerate(eng.active) if r is not None]
            rows.append(out[0][live].float().cpu())
            return out
        eng._decode = rec
        reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
                for i, (p, m) in enumerate(zip(prompts, (20, 2)))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        torch.cuda.synchronize()
        runs.append((reqs, eng.report(), int(eng.pos.max()), rows))
    (creqs, crep, cmax, crows), (reqs, rep, mx, rows) = runs
    top2 = torch.cat(crows).topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4
    assert [r.out for r in reqs] == [r.out for r in creqs]
    assert rep == crep and mx == cmax > 40


# ------------------------------------------- kernel B past shared memory
def test_chunk_words_and_the_named_refusal():
    """Kernel B's per-point words (20 a request, the bank counts): at the
    paper's 16 banks chunk 4096 needs 344,392 B, past a block's 227 KB;
    a chunk whose words pass int32 is refused by name before any card
    is asked."""
    assert t_cs.chunk_words(4096, 16) * 4 == 344_392
    assert t_cs.chunk_words(2048, 16) * 4 == 172_360
    with pytest.raises(t_cs.WorkspaceError, match="int32"):
        t_cs.chunk_layout("cpu", 2 ** 27, 16)
    with pytest.raises(t_cs.WorkspaceError):
        t_cs.chunk_layout("cpu", 0, 16)


def _paper_trace(cfg, n, seed, dev):
    rng = np.random.default_rng(seed)
    nf = cfg.n_fast_pages
    page = np.where(rng.random(n) < 0.5, nf + rng.integers(0, 64, n),
                    rng.integers(0, nf + 4096, n)).astype(np.int32)
    return tcore.Trace(*(torch.as_tensor(a, device=dev) for a in (
        page, (rng.integers(0, cfg.page_size // 64, n) * 64).astype(np.int32),
        rng.random(n) < 0.4, np.full(n, 64, np.int32))))


@pytest.mark.cuda
def test_chunk_step_workspace_layout_equals_the_scan_path(cuda_device):
    """Chunk 4096 at the paper's geometry: kernel B on its global
    workspace, one launch, bitwise equal to "off"; a B = 2 sweep in one
    launch, each point equal to its own run; chunk 2048 on shared
    memory."""
    from repro_torch.sweep import SweepSpec, build_points
    base = tcore.paper_platform().with_(chunk=4096, hot_threshold=2)
    trace = _paper_trace(base, 3 * 4096 - 5, 3, cuda_device)
    assert t_cs.chunk_layout(str(cuda_device), 4096, 16)[0] == "workspace"
    assert t_cs.chunk_layout(str(cuda_device), 2048, 16)[0] == "shared"
    t_cs.KERNEL.reset()
    got = repro_torch.Engine(base).run(trace)
    torch.cuda.synchronize()
    assert t_cs.KERNEL.variant_launches == {"shared": 0, "workspace": 1}
    want = repro_torch.Engine(base.with_(chunk_step_kernel="off")).run(trace)
    _assert_equal(tuple(_leaves(got)), tuple(_leaves(want)))
    for chunk, layout in ((4096, "workspace"), (2048, "shared")):
        cfg = base.with_(chunk=chunk)
        spec = SweepSpec(cfg, policies=("hotness", "write_bias"))
        eng = repro_torch.Engine(cfg)
        t_cs.KERNEL.reset()
        res = eng.sweep(spec, trace)
        torch.cuda.synchronize()
        assert t_cs.KERNEL.variant_launches[layout] == 1
        assert t_cs.KERNEL.launches == 1
        n = len(trace)
        for i, p in enumerate(build_points(spec)):
            one = eng.run(trace, params=p.params(cuda_device))
            _assert_equal((_point(res.states, i),
                           {k: v[:n] for k, v in _point(res.outs,
                                                         i).items()}),
                          tuple(one))


@pytest.mark.cuda
def test_chunk_one_on_the_card_equals_trace_sim(cuda_device):
    """The paper's geometry at chunk 1 (one launch over 2,000 one-request
    chunks) against the port's sequential simulator."""
    from repro_torch.sims import trace_sim
    cfg = tcore.paper_platform().with_(chunk=1, policy="write_bias",
                                       hot_threshold=4, decay_every=64,
                                       write_weight=4)
    trace = _paper_trace(cfg, 2000, 4, cuda_device)
    before = t_cs.KERNEL.launches
    res = repro_torch.Engine(cfg).run(trace)
    torch.cuda.synchronize()
    assert t_cs.KERNEL.launches == before + 1
    oracle = trace_sim.simulate(cfg, *(x.cpu().numpy() for x in trace))
    for k in ("returns", "latency", "device"):
        assert np.array_equal(res.outs[k].cpu().numpy(), getattr(oracle, k))
    assert int(res.state.clock) == oracle.clock
    assert int(res.state.dma.swaps_done) == oracle.swaps > 0
