"""The port's ``HybridAllocator`` and ``TieredKVAccounting`` against the
JAX package's, on the CPU.

The allocator cases of ``tests/test_policies_table.py`` and
``tests/test_endurance.py`` (pop order, spill, the ``MemoryError``
rollback, pin stamps, retirement) run on both packages' allocators side
by side; the tiered KV-cache cases of ``tests/test_engine.py`` and
``tests/test_serve.py`` compare ``report()``, the final table and the set
of pinned pages. Every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import table as j_table
from repro.core.table import HybridAllocator as JAlloc
from repro.memtier.tiered_cache import TieredKVAccounting as JTier

import repro_torch.core as tcore
from repro_torch.core import FAST, SLOW, HybridAllocator
from repro_torch.core import table as t_table
from repro_torch.memtier import TieredKVAccounting

from test_torch_core import assert_same


def _pair(**kw):
    return jcore.small_platform(**kw), tcore.small_platform(**kw)


# ----------------------------------------------------------- allocator
@pytest.mark.parametrize("seed", range(4))
def test_allocator_ops_match(seed):
    """A random sequence of alloc (hints, pins, spills, refusals), free
    and retire on both allocators: the same pages, handles, errors and
    pool sizes after every operation; freeing everything restores the
    pools (``test_allocator_roundtrip``)."""
    cfg_j, cfg_t = _pair()
    ja, ta = JAlloc(cfg_j), HybridAllocator(cfg_t)
    total = dict(ta.free_pages)
    rng = np.random.default_rng(seed)
    live = []
    for _ in range(40):
        op = rng.random()
        if op < 0.6 or not live:
            n = int(rng.integers(1, 12 if op > 0.55 else 6))
            hint = FAST if rng.random() < 0.5 else SLOW
            pin = bool(rng.random() < 0.3)
            try:
                jh, jp = ja.alloc(n, hint=hint, pin=pin)
            except MemoryError:
                with pytest.raises(MemoryError, match="out of hybrid"):
                    ta.alloc(n, hint=hint, pin=pin)
            else:
                th, tp = ta.alloc(n, hint=hint, pin=pin)
                assert jh == th and tp.dtype == np.int32
                np.testing.assert_array_equal(jp, tp)
                assert len(set(tp.tolist())) == n
                live.append(th)
        elif op < 0.9:
            h = live.pop(int(rng.integers(len(live))))
            ja.free(h)
            ta.free(h)
        else:
            dead = rng.integers(0, cfg_t.n_pages, 2)
            ja.retire(dead)
            ta.retire(dead)
        assert ja.free_pages == ta.free_pages
        assert ja.retired_pages == ta.retired_pages
    for h in live:
        ja.free(h)
        ta.free(h)
    assert ja.free_pages == ta.free_pages
    if not ta.retired_pages:
        assert ta.free_pages == total


def test_allocator_hint_honoured_then_spills():
    cfg_j, cfg_t = _pair()           # 8 fast pages
    ja, ta = JAlloc(cfg_j), HybridAllocator(cfg_t)
    _, p1 = ta.alloc(8, hint=FAST)
    np.testing.assert_array_equal(p1, ja.alloc(8, hint=FAST)[1])
    assert all(p < cfg_t.n_fast_pages for p in p1)
    _, p2 = ta.alloc(4, hint=FAST)    # fast exhausted -> spills to slow
    np.testing.assert_array_equal(p2, ja.alloc(4, hint=FAST)[1])
    assert all(p >= cfg_t.n_fast_pages for p in p2)
    before = dict(ta.free_pages)
    with pytest.raises(MemoryError):
        ta.alloc(cfg_t.n_pages, hint=SLOW)
    assert ta.free_pages == before    # rolled back, in the same order
    _, p3 = ta.alloc(3, hint=SLOW)
    with pytest.raises(MemoryError):
        ja.alloc(cfg_j.n_pages, hint=SLOW)
    np.testing.assert_array_equal(p3, ja.alloc(3, hint=SLOW)[1])


def test_allocator_pin_hints_stamp_flags():
    """Pin hints stamped by ``apply_flags`` (in place on the port) equal
    the JAX package's table; freeing releases the pins."""
    cfg_j, cfg_t = _pair()                       # 8 fast / 56 slow
    ja, ta = JAlloc(cfg_j), HybridAllocator(cfg_t)
    handles = []
    for n, hint, pin in ((4, FAST, True), (3, SLOW, True), (2, FAST, False),
                         (6, FAST, True)):       # the last one spills
        handles.append(ta.alloc(n, hint=hint, pin=pin)[0])
        ja.alloc(n, hint=hint, pin=pin)
    table = t_table.init_table(cfg_t)
    got = ta.apply_flags(table)
    assert got is table
    assert_same(ja.apply_flags(j_table.init_table(cfg_j)), got, "pinned")
    flg = t_table.flags(got).numpy()
    assert (flg == t_table.PIN_FAST).sum() == 6
    assert (flg == t_table.PIN_SLOW).sum() == 7
    t_table.check_table(cfg_t, got)
    for h in (handles[0], handles[1], handles[3]):
        ja.free(h)
        ta.free(h)
    table2 = ta.apply_flags(t_table.init_table(cfg_t))
    assert not t_table.flags(table2).any()
    assert_same(ja.apply_flags(j_table.init_table(cfg_j)), table2, "freed")


def test_allocator_retire_permanent():
    cfg_j, cfg_t = _pair()
    ja, ta = JAlloc(cfg_j), HybridAllocator(cfg_t)
    h, pages = ta.alloc(4)
    ja.alloc(4)
    ta.retire(pages[:2])
    ja.retire(pages[:2])
    ta.free(h)
    ja.free(h)
    free = ta.free_pages
    assert free == ja.free_pages
    assert free[0] + free[1] == cfg_t.n_pages - 2
    assert ta.retired_pages == {int(p) for p in pages[:2]}
    # retired pages are never handed out again
    _, fresh = ta.alloc(cfg_t.n_pages - 2)
    assert not (set(fresh.tolist()) & ta.retired_pages)
    np.testing.assert_array_equal(fresh, ja.alloc(cfg_j.n_pages - 2)[1])


# ---------------------------------------------------------- tiered cache
def _assert_tiers_equal(jt, tt):
    jrep, trep = jt.report(), tt.report()
    assert jrep == trep
    assert_same(jt.state.table, tt.state.table, "table")
    assert_same(jt.state.counters, tt.state.counters, "counters")
    assert jt._pinned == tt._pinned
    assert jt._pages == tt._pages


def test_tiered_cache_pins_and_reports_contract_hit_rate():
    """As ``tests/test_engine.py``: pinned pages never migrate, the
    report's pinned-page fast hit rate, the release on
    ``free_sequence``; report, table and pins equal the JAX package's."""
    kw = dict(n_fast_pages=4, n_slow_pages=60, chunk=16, policy="hotness",
              hot_threshold=2)
    cfg_j, cfg_t = jcore.EmulatorConfig(**kw), tcore.EmulatorConfig(**kw)
    args = dict(n_layers=2, positions_per_page=16, bytes_per_position=64,
                pin_pages_per_seq=1)
    jt, tt = JTier(cfg_j, **args), TieredKVAccounting(cfg_t, **args,
                                                      device="cpu")
    for step in range(12):
        lens = [16 * (1 + step % 3) + step] * 3
        jr = jt.account(jt.access_trace([0, 1, 2], lens))
        trace = tt.access_trace([0, 1, 2], lens)
        assert trace.page.device.type == "cpu" and len(trace) == \
            len(jt.access_trace([0, 1, 2], lens).page)
        assert jr == tt.account(trace)
    _assert_tiers_equal(jt, tt)
    rep = tt.report()
    assert rep["pinned_pages"] == 3 and rep["pinned_accesses"] > 0
    assert 0.0 <= rep["pinned_fast_hit_rate"] <= 1.0
    table = tt.state.table.numpy()
    for page in tt._pinned:
        flags = table[page, t_table.FLAGS]
        assert flags & t_table.PINNED
        if flags & t_table.PIN_FAST:
            assert table[page, t_table.DEVICE] == FAST
    jt.free_sequence(0)
    tt.free_sequence(0)
    assert tt.report()["pinned_pages"] == 2
    _assert_tiers_equal(jt, tt)


@pytest.mark.parametrize("policy", ["hotness", "static"])
def test_tiered_cache_windows_spill_and_recycle(policy):
    """A longer run past the fast tier: windowed sequences, a sequence
    freed and its pages recycled by a new one, two pinned pages a
    sequence; equal to the JAX package's after every step."""
    kw = dict(n_fast_pages=8, n_slow_pages=56, chunk=16, policy=policy,
              hot_threshold=2, decay_every=4)
    cfg_j, cfg_t = jcore.EmulatorConfig(**kw), tcore.EmulatorConfig(**kw)
    args = dict(n_layers=1, positions_per_page=8, bytes_per_position=128,
                pin_pages_per_seq=2)
    jt, tt = JTier(cfg_j, **args), TieredKVAccounting(cfg_t, **args,
                                                      device="cpu")
    seqs, lens = [0, 1, 2], [9, 20, 3]
    for step in range(10):
        wins = [None, 16, None]
        if step == 5:
            jt.free_sequence(1)
            tt.free_sequence(1)
            seqs[1], lens[1] = 7, 1
        assert jt.account(jt.access_trace(seqs, lens, wins)) == \
            tt.account(tt.access_trace(seqs, lens, wins))
        _assert_tiers_equal(jt, tt)
        lens = [n + 3 for n in lens]
    tcore.check_table(cfg_t, tt.state.table)


def test_tiered_cache_pins_recycled_page_to_its_current_tier():
    """As ``tests/test_engine.py``: a fast-id page that migration demoted
    gets PIN_SLOW, and a page in the DMA's in-flight swap the tier the
    swap moves it to; both equal to the JAX package's."""
    kw = dict(n_fast_pages=4, n_slow_pages=28, chunk=16, policy="static")
    cfg_j, cfg_t = jcore.EmulatorConfig(**kw), tcore.EmulatorConfig(**kw)
    args = dict(n_layers=1, positions_per_page=16, bytes_per_position=64,
                pin_pages_per_seq=1)
    s = cfg_t.n_fast_pages + 5

    def j_demote(t):
        fs = int(t[s, j_table.FRAME])
        t = (t.at[1, j_table.DEVICE].set(SLOW)
             .at[1, j_table.FRAME].set(fs))
        t = t.at[s, j_table.DEVICE].set(0).at[s, j_table.FRAME].set(1)
        return t.at[1, j_table.OWNER].set(s)

    def t_demote(t):
        t = t.clone()
        fs = int(t[s, t_table.FRAME])
        t[1, t_table.DEVICE], t[1, t_table.FRAME] = SLOW, fs
        t[s, t_table.DEVICE], t[s, t_table.FRAME] = FAST, 1
        t[1, t_table.OWNER] = s
        return t

    for in_swap in (False, True):
        jt, tt = JTier(cfg_j, **args), TieredKVAccounting(cfg_t, **args,
                                                          device="cpu")
        assert jt._page_for(0, 0) == tt._page_for(0, 0) == 0
        jt.state = jt.state._replace(table=j_demote(jt.state.table))
        tt.state = tt.state._replace(table=t_demote(tt.state.table))
        if in_swap:
            jt.state = jt.state._replace(dma=jt.state.dma._replace(
                active=jnp.int32(1), page_a=jnp.int32(1),
                page_b=jnp.int32(s)))
            tt.state = tt.state._replace(dma=tt.state.dma._replace(
                active=torch.tensor(1, dtype=torch.int32),
                page_a=torch.tensor(1, dtype=torch.int32),
                page_b=torch.tensor(s, dtype=torch.int32)))
        assert jt._page_for(1, 0) == tt._page_for(1, 0) == 1
        want = t_table.PIN_FAST if in_swap else t_table.PIN_SLOW
        assert int(tt.state.table[1, t_table.FLAGS]) == want
        assert_same(jt.state.table, tt.state.table, "table")
        if not in_swap:
            tcore.check_table(cfg_t, tt.state.table)


def test_tiered_report_zero_pinned_accesses_is_zero_not_nan():
    """As ``tests/test_serve.py``: a sequence that pins and ends before
    any access reads a 0.0 pinned hit rate, as in the JAX package."""
    kw = dict(n_fast_pages=64, n_slow_pages=448, chunk=16)
    cfg_j, cfg_t = jcore.small_platform(**kw), tcore.small_platform(**kw)
    args = dict(n_layers=1, positions_per_page=16, bytes_per_position=64,
                pin_pages_per_seq=1)
    jt, tt = JTier(cfg_j, **args), TieredKVAccounting(cfg_t, **args,
                                                      device="cpu")
    for tier in (jt, tt):
        tier._page_for(0, 0)
        tier.free_sequence(0)
    rate = tt.report()["pinned_fast_hit_rate"]
    assert rate == 0.0 and not np.isnan(rate)
    assert jt.report() == tt.report()


def test_tiered_cache_runs_on_cuda_unless_asked():
    """Like ``Engine``, the accounting runs on ``cuda`` by default and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TieredKVAccounting(tcore.small_platform(), n_layers=1)
