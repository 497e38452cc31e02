"""The chunk-step kernel's algorithms, mirrored in plain code, on the CPU.

The CUDA kernel (``csrc/chunk_step.cu``) runs only on a card. What it
computes differently from its plain version is mirrored here step for
step and held bit for bit against the plain version and the JAX package:

* the two-level max-plus block scan of the RX and TX links (each of 512
  threads takes its run of requests, then a warp scan of 32 lanes, then a
  scan of the 16 warp totals), against ``_seq_maxplus`` and
  ``repro.core.latency.maxplus_scan``;
* the bank queues as a counting sort by lane and one warp per lane over
  its requests, 32 a round, the lane register carried, against
  ``_seq_bank_resolve`` and the JAX resolvers;
* the counter fold (each chunk's integer sums exactly, rounded once, then
  ``c + s`` in float32), against ``counters.update`` in both packages;
* the Python around the one-launch route (packing, the write-back into
  the passed state, the per-request outputs), with the kernel replaced by
  a plain implementation of its contract.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings, strategies as st

import repro.core as jcore
from repro.core import counters as j_ctr, latency as j_lat

import repro_torch
import repro_torch.core as tcore
from repro_torch.core import counters as t_ctr
from repro_torch.core.config import RuntimeParams
from repro_torch.core.emulator import clone_state
from repro_torch.kernels import chunk_step as tcs

from test_torch_core import POLICIES, T, assert_same, t_params, t_plan, t_state
from test_torch_kernels import _scenario, _t_scalars

INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
NEG = -2 ** 30
M32 = 2 ** 32
THREADS, LANES = 512, 32


# ------------------------------------------------------------ the mirrors
def wrap(x):
    """int64 -> the int32 value two's-complement arithmetic gives."""
    return (np.asarray(x, np.int64) + 2 ** 31) % M32 - 2 ** 31


def ident(shape=()):
    return np.zeros(shape, np.int64), np.full(shape, INT_MIN, np.int64)


def then(f, g):
    """Max-plus maps (s, a): x -> max(x + s, a); f then g. ``s`` is a
    uint32 (held in int64), ``a`` an int32; the adds wrap."""
    return (f[0] + g[0]) % M32, np.maximum(wrap(f[1] + g[0]), g[1])


def elem(arrival, service):
    s = np.asarray(service, np.int64) % M32
    return s, wrap(np.asarray(arrival, np.int64) + s)


def shift_lanes(x, d):
    """Each lane gets lane - d's value (``__shfl_up_sync``); lanes below d
    get the identity."""
    s, a = x
    out_s, out_a = ident(s.shape)
    out_s[..., d:], out_a[..., d:] = s[..., :-d], a[..., :-d]
    return out_s, out_a


def warp_scan(x):
    """Inclusive scan over the last axis (32 lanes), Kogge-Stone."""
    for d in (1, 2, 4, 8, 16):
        up = shift_lanes(x, d)
        x = then(up, x)   # the shifted identity leaves lanes < d alone
    return x


def block_maxplus(arrival, service):
    """The kernel's ``block_maxplus``: done_i of done_i = max(arr_i,
    done_{i-1}) + srv_i from done_{-1} = INT32_MIN."""
    n = len(arrival)
    per = -(-n // THREADS)
    es, ea = elem(arrival, service)
    tid = np.arange(THREADS)

    def step(acc, k, emit=None):
        idx = tid * per + k
        m = idx < n
        ic = np.minimum(idx, n - 1)
        e = (np.where(m, es[ic], 0), np.where(m, ea[ic], INT_MIN))
        acc = then(acc, e)
        if emit is not None:
            emit[idx[m]] = acc[1][m]
        return acc

    run = ident(THREADS)
    for k in range(per):
        run = step(run, k)
    incl = warp_scan(tuple(v.reshape(-1, LANES) for v in run))
    ex = shift_lanes(incl, 1)
    totals = ident(LANES)
    nw = THREADS // LANES
    totals[0][:nw], totals[1][:nw] = incl[0][:, -1], incl[1][:, -1]
    warp_ex = shift_lanes(warp_scan(totals), 1)
    pre = then((warp_ex[0][:nw, None], warp_ex[1][:nw, None]), ex)
    pre = tuple(v.reshape(-1) for v in pre)
    out = np.zeros(n, np.int64)
    for k in range(per):
        pre = step(pre, k, out)
    return out.astype(np.int32)


def lane_resolve(arrival, service, bank, bank_free):
    """The kernel's stage 3: each lane's requests in order (the counting
    sort), scanned 32 a round with the lane's register carried; a request
    whose bank is out of range sits in the clamped lane, reads its
    register and writes nothing."""
    n, nb = len(arrival), len(bank_free)
    bw = np.where(bank < 0, bank + nb, bank)
    upd = (bw >= 0) & (bw < nb)
    lane = np.clip(bw, 0, nb - 1)
    arr = np.maximum(np.asarray(arrival, np.int64), NEG)
    srv = np.asarray(service, np.int64)
    done = np.zeros(n, np.int64)
    free = np.asarray(bank_free, np.int64).copy()
    for L in range(nb):
        free0 = free[L]
        carry = ident()
        seg = np.flatnonzero(lane == L)
        for j0 in range(0, len(seg), LANES):
            idx = seg[j0:j0 + LANES]
            k = len(idx)
            es, ea = elem(arr[idx], srv[idx])
            e = ident(LANES)
            e[0][:k] = np.where(upd[idx], es, 0)
            e[1][:k] = np.where(upd[idx], ea, INT_MIN)
            incl = warp_scan(e)
            ex = shift_lanes(incl, 1)
            pre = then(carry, (ex[0][:k], ex[1][:k]))
            reg = np.maximum(wrap(free0 + pre[0]), pre[1])
            done[idx] = wrap(np.maximum(arr[idx], reg) + srv[idx])
            carry = then(carry, (incl[0][-1], incl[1][-1]))
        free[L] = max(int(wrap(free0 + carry[0])), int(carry[1]))
    return done.astype(np.int32), free.astype(np.int32)


def seq_unwrapped(arrival, service):
    """The sequential recurrence in Python ints (no wrap)."""
    prev, out = INT_MIN, []
    for a, s in zip(arrival.tolist(), service.tolist()):
        prev = max(a, prev) + s
        out.append(prev)
    return out


# ------------------------------------------------------- max-plus inputs
def maxplus_case(seed, n, mode):
    """Arrivals and services with invalid slots (arrival NEG, service 0),
    arrivals at NEG, and ("wrap") service sums past 2^31 while every done
    time stays in int32."""
    rng = np.random.default_rng(seed)
    arrival = np.sort(rng.integers(-1000, 5 * n, n)).astype(np.int64)
    service = rng.integers(0, 40, n).astype(np.int64)
    arrival[rng.random(n) < 0.1] = NEG
    if mode == "wrap":
        arrival[:] = NEG
        service = rng.integers(0, min(INT_MAX, (3 * 2 ** 30 - 1) // n), n)
    elif mode == "high":
        arrival = arrival + (2 ** 31 - 40 * n - 5 * n - 10)
    invalid = rng.random(n) < 0.15
    arrival[invalid] = NEG
    service[invalid] = 0
    return arrival.astype(np.int32), service.astype(np.int32)


@pytest.mark.parametrize("mode", ["plain", "wrap", "high"])
@pytest.mark.parametrize("n", [1, 16, 100, 512, 1030])
def test_block_maxplus_matches_the_sequential_loop(n, mode):
    arrival, service = maxplus_case(n, n, mode)
    assert max(seq_unwrapped(arrival, service)) <= INT_MAX
    got = block_maxplus(arrival, service)
    want = tcs._seq_maxplus(T(arrival), T(service)).numpy()
    np.testing.assert_array_equal(got, want)
    cs = np.cumsum(service.astype(np.int64))
    lifted = arrival - (cs - service)
    if cs.max() <= INT_MAX and lifted.min() >= INT_MIN:
        # The JAX package's closed form holds while neither its cumsum nor
        # arrival - (cumsum - service) wraps; the block scan matches it
        # there.
        np.testing.assert_array_equal(
            got, np.asarray(j_lat.maxplus_scan(jnp.asarray(arrival),
                                               jnp.asarray(service))))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(data=st.data(), n=st.integers(1, 600))
def test_block_maxplus_property(data, n):
    """Any arrivals in [NEG, 2^30] (NEG often), services up to 2^26:
    wherever the sequential values stay in int32 (sums may wrap), the
    block scan gives the sequential loop's values."""
    arr_el = st.one_of(st.just(NEG), st.integers(NEG, 2 ** 30))
    arrival = np.array(data.draw(st.lists(arr_el, min_size=n, max_size=n)),
                       np.int32)
    service = np.array(data.draw(st.lists(st.integers(0, 2 ** 26),
                                          min_size=n, max_size=n)), np.int32)
    assume(max(seq_unwrapped(arrival, service)) <= INT_MAX)
    np.testing.assert_array_equal(
        block_maxplus(arrival, service),
        tcs._seq_maxplus(T(arrival), T(service)).numpy())


# ------------------------------------------------------------ bank lanes
def bank_case(seed, n, nb, out_of_range):
    rng = np.random.default_rng(seed)
    arrival = np.sort(rng.integers(0, 6 * n, n)).astype(np.int32)
    arrival[rng.random(n) < 0.1] = NEG
    service = rng.integers(0, 300, n).astype(np.int32)
    # Skewed banks: a few hot lanes, so some groups hold many requests.
    bank = np.where(rng.random(n) < 0.5, rng.integers(0, 3, n),
                    rng.integers(0, nb, n)).astype(np.int32)
    if out_of_range:
        bank[rng.random(n) < 0.1] = -1
        bank[rng.random(n) < 0.05] = nb + 2
        bank[rng.random(n) < 0.05] = -nb - 3
    bank_free = rng.integers(0, 4 * n, nb).astype(np.int32)
    return arrival, service, bank, bank_free


@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("n,nb", [(16, 8), (512, 32), (700, 32)])
def test_lane_resolve_matches_the_sequential_loop(n, nb, out_of_range):
    arrival, service, bank, bank_free = bank_case(n + nb, n, nb,
                                                  out_of_range)
    done, free = lane_resolve(arrival, service, bank, bank_free)
    w_done, w_free = tcs._seq_bank_resolve(T(arrival), T(service), T(bank),
                                           T(bank_free))
    np.testing.assert_array_equal(done, w_done.numpy())
    np.testing.assert_array_equal(free, w_free.numpy())
    if not out_of_range:
        # The JAX resolvers (dense and segmented) take banks in range.
        for resolve in (j_lat.resolve_bank_queues,
                        j_lat.resolve_bank_queues_segmented):
            j_done, j_free = resolve(*map(jnp.asarray, (arrival, service,
                                                        bank)), nb,
                                     jnp.asarray(bank_free))
            np.testing.assert_array_equal(done, np.asarray(j_done))
            np.testing.assert_array_equal(free, np.asarray(j_free))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(data=st.data(), n=st.integers(1, 300), nb=st.sampled_from([2, 8, 32]))
def test_lane_resolve_property(data, n, nb):
    """Any arrivals (NEG often), services, banks in [-nb - 2, nb + 2) and
    registers: the per-lane scan gives the sequential loop's values
    wherever those stay in int32."""
    ints = st.integers
    arrival = np.array(data.draw(st.lists(
        st.one_of(st.just(NEG), ints(NEG, 2 ** 29)), min_size=n,
        max_size=n)), np.int32)
    service = np.array(data.draw(st.lists(ints(0, 2 ** 20), min_size=n,
                                          max_size=n)), np.int32)
    bank = np.array(data.draw(st.lists(ints(-nb - 2, nb + 1), min_size=n,
                                       max_size=n)), np.int32)
    bank_free = np.array(data.draw(st.lists(ints(NEG, 2 ** 29), min_size=nb,
                                            max_size=nb)), np.int32)
    # The register chain of every lane, unwrapped, stays in int32.
    bound = 2 ** 29 + int(service.astype(np.int64).sum())
    assume(bound <= INT_MAX)
    done, free = lane_resolve(arrival, service, bank, bank_free)
    w_done, w_free = tcs._seq_bank_resolve(T(arrival), T(service), T(bank),
                                           T(bank_free))
    np.testing.assert_array_equal(done, w_done.numpy())
    np.testing.assert_array_equal(free, w_free.numpy())


# ----------------------------------------------------------- the counters
def exact_fma32(a, b, c):
    """``a * b + c`` of three float32 numbers, computed exactly with
    fractions and rounded once to float32 (nearest, ties to even)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    lo = np.float32(float(exact))       # within one float32 step of exact
    for cand in (np.nextafter(lo, np.float32(-np.inf)),
                 np.nextafter(lo, np.float32(np.inf))):
        d_lo, d_c = abs(Fraction(float(lo)) - exact), \
            abs(Fraction(float(cand)) - exact)
        if d_c < d_lo or (d_c == d_lo and
                          int(cand.view(np.int32)) % 2 == 0):
            lo = cand
    return np.float32(lo)


def energy_fma(p, brf, bwf, brs, bws):
    """A chunk's energy in float32 as the reference computes it under
    ``jit`` (XLA's two fused multiply-adds): ``fma(8*bws, p_sw,
    fma(bits_fast, p_f, (8*brs) * p_sr))``."""
    f32 = np.float32
    bits_fast = f32(f32(8.0) * f32(f32(brf) + f32(bwf)))
    inner = exact_fma32(bits_fast, p["power_pj_per_bit_fast"],
                        f32(f32(f32(8.0) * f32(brs))
                            * p["power_pj_per_bit_slow_read"]))
    return exact_fma32(f32(f32(8.0) * f32(bws)),
                       p["power_pj_per_bit_slow_write"], inner)


def kernel_fold(p, c, *, device, is_write, size, valid, latency, held,
                poisoned, retired, injected):
    """The kernel's counter fold in numpy float32: exact int64 chunk sums,
    one rounding each, then c + s, and the energy as the reference
    computes it under ``jit`` (:func:`energy_fma`)."""
    f32 = np.float32
    v, iw, slow = valid, is_write, device == 1
    r, w = ~iw & v, iw & v
    size = np.where(v, size, 0).astype(np.int64)

    def s(mask, x):
        return f32(np.where(mask, x, 0).astype(np.int64).sum())
    brf, bwf = s(r & ~slow, size), s(w & ~slow, size)
    brs, bws = s(r & slow, size), s(w & slow, size)
    energy = energy_fma(p, brf, bwf, brs, bws)
    i32 = np.int32
    return {
        "reads_fast": i32(c["reads_fast"] + (r & ~slow).sum()),
        "writes_fast": i32(c["writes_fast"] + (w & ~slow).sum()),
        "reads_slow": i32(c["reads_slow"] + (r & slow).sum()),
        "writes_slow": i32(c["writes_slow"] + (w & slow).sum()),
        "bytes_read_fast": f32(c["bytes_read_fast"] + brf),
        "bytes_write_fast": f32(c["bytes_write_fast"] + bwf),
        "bytes_read_slow": f32(c["bytes_read_slow"] + brs),
        "bytes_write_slow": f32(c["bytes_write_slow"] + bws),
        "sum_read_latency": f32(c["sum_read_latency"]
                                + s(r, latency)),
        "n_reads": i32(c["n_reads"] + r.sum()),
        "max_latency": i32(max(c["max_latency"],
                               np.where(v, latency, 0).max())),
        "reorder_held": i32(c["reorder_held"] + held),
        "energy_pj": f32(c["energy_pj"] + energy),
        "poison_faults": i32(c["poison_faults"] + poisoned.sum()),
        "frames_retired": i32(c["frames_retired"] + retired),
        "transient_faults": i32(c["transient_faults"] + injected.sum()),
    }


def test_counter_fold_matches_update_and_jax():
    """Six chunks of 512 through the kernel's fold, the port's
    ``counters.update`` and the JAX package's: every counter bit for bit
    after every chunk, except where a chunk's read latencies sum past
    2^24. There (chunk 3, ~2.9e7) the port and the kernel both take the
    correctly rounded sum; the JAX package's float32 sum depends on
    XLA's order of additions, and is held to its rounding bound."""
    jp = jcore.small_platform().runtime()
    pn = {f: np.float32(getattr(jp, f)) for f in jp._fields
          if f.startswith("power")}
    rng = np.random.default_rng(5)
    jc = j_ctr.Counters.zeros()
    tc = t_ctr.Counters.zeros()
    kc = {f: np.asarray(getattr(tc, f)).item() for f in tc._fields}
    kc = {f: (np.float32 if f in t_ctr.FLOAT_FIELDS else np.int32)(x)
          for f, x in kc.items()}
    n = 512
    for chunk in range(6):
        big = chunk == 3
        lat = rng.integers(50_000, 64_000, n) if big else \
            rng.integers(100, 9_000, n)
        ins = dict(device=rng.integers(0, 2, n).astype(np.int32),
                   is_write=rng.random(n) < 0.3,
                   size=rng.choice([64, 128, 4096], n).astype(np.int32),
                   valid=rng.random(n) < 0.97,
                   latency=lat.astype(np.int32),
                   held=np.int32(rng.integers(0, n)),
                   poisoned=rng.random(n) < 0.01,
                   retired=np.int32(chunk % 2),
                   injected=rng.random(n) < 0.01)
        read_sum = int(np.where(ins["valid"] & ~ins["is_write"],
                                ins["latency"], 0).sum())
        assert (read_sum > 2 ** 24) == big
        kc = kernel_fold(pn, kc, **ins)
        tc = t_ctr.update(t_params(jp), tc, **{k: T(v) for k, v in
                                               ins.items()})
        jc = jax.jit(j_ctr.update)(jp, jc, **{k: jnp.asarray(v) for k, v in
                                              ins.items()})
        for f in tc._fields:
            got = getattr(tc, f).numpy()
            assert got.dtype == kc[f].dtype and got == kc[f], (chunk, f)
            if f != "sum_read_latency" or chunk < 3:
                assert_same(getattr(jc, f), getattr(tc, f), f"{chunk} {f}")
            else:
                j, t = float(getattr(jc, f)), float(got)
                assert abs(j - t) <= n * 2.0 ** -23 * t, (chunk, j, t)


# ------------------------------------------- the Python around the launch
def plain_kernel(cfg, registry, table, ints, floats, bank_free, page, offset,
                 is_write, size, valid, transient, deaths, counters_int,
                 counters_float, *, phases=None, cluster=None):
    """``chunk_step_cuda``'s contract in plain PyTorch: per design point
    the loop of ``step_ref(seq=True)`` and ``counters.update`` over the
    chunks, the table updated in place. ``phases``, which picks the
    kernel's stamped instantiation, must be an int64[B, len(PHASES)];
    clock64() cycles have no plain counterpart, so it is left as it is."""
    if phases is not None:
        assert phases.dtype == torch.int64
        assert tuple(phases.shape) == (table.shape[0], len(tcs.PHASES))
    n_sc = len(tcs.SC_FIELDS)
    chunk = cfg.chunk
    points = []
    for b in range(table.shape[0]):
        params = RuntimeParams(
            **{f: ints[b, n_sc + k].clone()
               for k, f in enumerate(tcs.INT_PARAM_FIELDS)},
            **{f: floats[b, k].clone()
               for k, f in enumerate(tcs.FLOAT_PARAM_ORDER)})
        sc = tcs._unpack_out_scalars(ints[b, :n_sc].clone())
        ctr = t_ctr.Counters(
            **dict(zip(tcs.COUNTER_INT_FIELDS, counters_int[b].clone())),
            **dict(zip(tcs.COUNTER_FLOAT_FIELDS, counters_float[b].clone())))
        plan = tcore.FaultPlan(transient[b], deaths[b])
        tab, bf, outs = table[b], bank_free[b].clone(), []
        for c in range(page.shape[1] // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            v, iw = valid[b, sl] != 0, is_write[b, sl] != 0
            sz = torch.where(v, size[b, sl], 0)
            tab, sc, bf, o = tcs.step_ref(cfg, registry, tab, params, sc, bf,
                                          page[b, sl], offset[b, sl], iw, sz,
                                          v, plan, seq=True)
            ctr = t_ctr.update(params, ctr, device=o["device"], is_write=iw,
                               size=sz, valid=v, latency=o["latency"],
                               held=o["held"], poisoned=o["poisoned"],
                               retired=o["retired"] >= 0,
                               injected=o["injected"])
            outs.append(o)

        def cat(k):
            return torch.cat([o[k] for o in outs]).to(torch.int32)
        points.append(tcs.KernelOut(
            torch.stack(tcs.scalar_tensors(sc)), bf,
            torch.stack([torch.stack([o[k] for k in tcs.CHUNK_OUT])
                         for o in outs]),
            *(cat(k) for k in ("returns", "device", "latency", "poisoned",
                               "injected")),
            torch.stack([getattr(ctr, f) for f in tcs.COUNTER_INT_FIELDS]),
            torch.stack([getattr(ctr, f) for f in tcs.COUNTER_FLOAT_FIELDS])))
    return tcs.KernelOut(*(torch.stack(x) for x in zip(*points)))


def _flat(x):
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _flat(x[k])]
    if isinstance(x, tuple):
        return [y for v in x for y in _flat(v)]
    return [x]


@pytest.mark.parametrize("policy", POLICIES)
def test_one_launch_route_writes_the_run_into_the_passed_state(
        policy, monkeypatch):
    """``Engine.run`` through the one-launch route, its kernel replaced by
    :func:`plain_kernel`: the same final state, counters and outputs as
    the per-chunk loop, written into the tensors of the state passed
    in."""
    _, cfg, js, arrays, jplan = _scenario(policy)
    eng = repro_torch.Engine(cfg, device="cpu")
    trace = tcore.Trace(*map(T, arrays[:4]))
    valid, plan, start = T(arrays[4]), t_plan(jplan), t_state(js)
    want = eng.run(trace, valid=valid, state=clone_state(start), faults=plan)
    monkeypatch.setattr(tcs, "chunk_step_cuda", plain_kernel)
    monkeypatch.setattr(tcs, "use_chunk_step_kernel", lambda c, t: True)
    state = clone_state(start)
    ptrs = [t.data_ptr() for t in _flat(state)]
    got = eng.run(trace, valid=valid, state=state, faults=plan)
    assert [t.data_ptr() for t in _flat(got.state)] == ptrs
    for a, b in zip(_flat(got.state), _flat(want.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.outs.keys() == want.outs.keys()
    for k in want.outs:
        assert got.outs[k].dtype == want.outs[k].dtype, k
        assert torch.equal(got.outs[k], want.outs[k]), k


@pytest.mark.parametrize("policy", POLICIES)
def test_loop_route_writes_the_run_into_the_passed_state(policy):
    """``Engine.run`` through the per-chunk loop (the CPU route): the
    final state and counters are written into the memory of the state
    passed in, as on the one-launch route, and equal a run on a clone;
    the returned state is new objects over that memory, and the donated
    one is consumed."""
    _, cfg, js, arrays, jplan = _scenario(policy)
    eng = repro_torch.Engine(cfg, device="cpu")
    trace = tcore.Trace(*map(T, arrays[:4]))
    valid, plan, start = T(arrays[4]), t_plan(jplan), t_state(js)
    before = [t.clone() for t in _flat(start)]
    want = eng.run(trace, valid=valid, state=start, donate=False,
                   faults=plan)
    for a, b in zip(_flat(start), before):
        assert torch.equal(a, b)
    state = clone_state(start)
    ptrs = [t.data_ptr() for t in _flat(state)]
    got = eng.run(trace, valid=valid, state=state, faults=plan)
    assert [t.data_ptr() for t in _flat(got.state)] == ptrs
    for a, b, w in zip(_flat(state), _flat(got.state), _flat(want.state)):
        assert a is not b and a.data_ptr() == b.data_ptr()
        assert a.dtype == w.dtype and torch.equal(a, w)
    assert int(got.state.chunk_idx) == int(start.chunk_idx) + \
        len(valid) // cfg.chunk
    with pytest.raises(RuntimeError, match="consumed"):
        eng.run(trace, valid=valid, state=state, faults=plan)


def test_chunk_step_launch_of_one_chunk(monkeypatch):
    """``chunk_step`` on the kernel route (one chunk per launch, its
    kernel replaced by :func:`plain_kernel`) against ``step_ref``."""
    _, cfg, js, arrays, jplan = _scenario("wear_level")
    reg = tcore.PolicyRegistry.snapshot()
    params, plan = t_params(cfg.runtime()), t_plan(jplan)
    ts = t_state(js)
    plain = (ts.table.clone(), _t_scalars(ts), ts.bank_free.clone())
    kern = (ts.table.clone(), _t_scalars(ts), ts.bank_free.clone())
    monkeypatch.setattr(tcs, "chunk_step_cuda", plain_kernel)
    monkeypatch.setattr(tcs, "use_chunk_step_kernel", lambda c, t: True)
    for c in range(len(arrays[0]) // cfg.chunk):
        sl = slice(c * cfg.chunk, (c + 1) * cfg.chunk)
        ch = [T(a[sl]) for a in arrays]
        *plain, po = tcs.step_ref(cfg, reg, plain[0], params, plain[1],
                                  plain[2], *ch, plan, seq=True)
        *kern, ko = tcs.chunk_step(cfg, reg, kern[0], params, kern[1],
                                   kern[2], *ch, plan)
        for a, b in zip(_flat((tuple(kern), ko)), _flat((tuple(plain), po))):
            assert torch.equal(a.to(torch.int32), b.to(torch.int32)), c

