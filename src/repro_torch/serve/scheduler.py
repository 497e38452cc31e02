"""Continuous-batching scheduler over the HMMU session API (PyTorch port
of ``repro.serve.scheduler``: the host logic line for line, numpy as
there; the device boundary is the port's own, below).

The scheduler plays the role the serving stack plays above the paper's
platform: it turns a population of concurrent sequence requests (each a
prompt prefill followed by windowed decode steps over its KV pages) into
the page-access stream the hybrid-memory emulator consumes, under the
disciplines real serving systems impose — admission control, bucketed
batch shapes, pin contracts, and eviction under memory pressure.

Design rules that make it scale to 100k+ live sequences on one host:

* **Host state is flat numpy** — slot tables, the page map
  (``PagedKVMap``), and the request buffer are arrays; a scheduling step
  is a handful of vectorized ops, never a Python loop over sequences.
* **Every dispatch shape is warmed up front** — trace lengths come from
  ``BucketSpec`` (steady-state floor selection carries the remainder;
  drain pads the tail up to the smallest covering bucket with an
  invalid-lane mask), and :meth:`ContinuousBatchingScheduler.warmup`
  dispatches every bucket once (on a card, building the chunk-step
  kernel), so ``Engine.compile_count`` stays flat for the whole serving
  run.
* **Scheduling never reads device results** — completion is decided by
  host-side decode counters, so dispatches stay asynchronous: at most
  ``max_live_batches`` un-harvested dispatches are in flight, and the
  host assembles batch ``k+1`` while the device emulates batch ``k``.
  Because the emulation is one pure scan over chunks, the scheduled run
  is bitwise identical to the same request stream replayed serially
  through ``Engine.run_stream`` — overlap depth changes wall-clock only.
* **Pin contracts are batched device ops** — stamped at admission and
  released at completion through ``serve.contracts`` at fixed pad
  widths, in place on the carried table, and never sync the host.

The device boundary on a card (``serve.staging``): each dispatch's trace
is built in pinned host memory and copied without waiting, its ``valid``
mask is built on the card, and ``ServeConfig.faults`` is placed on the
engine's device once, at construction. Right after each dispatch the
copy of its outputs into a pinned buffer is enqueued and an event
recorded; harvest waits on that event only (a plain ``.cpu()`` would also
wait for every later dispatch on the stream).

Graceful degradation under faults: when a :class:`~repro_torch.core.faults.
FaultPlan` rides along (``ServeConfig.faults``, threaded into every
dispatch — event chunk indices are absolute, so one plan spans the whole
run), harvest feeds recovery. Pages the emulator retired (the tombstone
parked on the dead frame and its rescued swap partner — both
conservatively dropped) leave circulation via ``PagedKVMap.
retire_pages``; dead *contract* pages are re-placed and re-stamped
immediately; transiently-faulted KV pages are invalidated so their
owners refetch. Contracts stranded off the fast tier (admission spills
or post-death re-placements) sit in a renegotiation queue and re-pin to
DRAM as fast pages free, so a retirement burst dents the pinned
fast-hit rate only transiently.

Latency accounting: each sequence's end-to-end latency is the emulated
span from its first prefill request issuing to its last decode request
returning (``returns - latency`` of the first request vs ``returns`` of
the last, folded per sequence with ``np.minimum.at`` / ``np.maximum.at``
at harvest). Cycles are reported as microseconds at the paper's 1 GHz
fabric clock (1 cycle = 1 ns).
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..core import FAST, SLOW
from ..core.emulator import Trace
from ..engine import Engine

from .buckets import BucketSpec
from .contracts import release_pin_pages, stamp_pin_pages
from .kv import PagedKVMap
from .staging import Fetch, to_device

_FIELDS = ("page", "offset", "is_write", "size", "rid", "pinned")
_LINE = 64
_LINES_PER_PAGE = 64


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the serving front-end (see README "Serving")."""

    sorted_batch_sizes: tuple[int, ...]   # allowed dispatch sizes (requests)
    max_live_seqs: int                    # admission cap on live sequences
    max_live_batches: int = 2             # un-harvested dispatches in flight
    max_admit_per_step: int = 1024        # admissions per scheduling step
    pin_pages_per_seq: int = 1            # leading pages pinned per sequence
    max_pages_per_seq: int = 8            # KV growth cap per sequence
    positions_per_page: int = 64          # decode tokens per KV page
    window_pages: int = 2                 # attention window (pages read/token)
    prefill_writes_per_page: int = 4      # prefill burst per prompt page
    free_low_frac: float = 0.02           # eviction low watermark (of pages)
    free_high_frac: float = 0.04          # eviction high watermark
    slo_latency_us: float = 100_000.0     # per-sequence latency SLO
    pinned_slo: float = 0.90              # pinned fast-hit-rate SLO
    record_traces: bool = False           # keep host copies for replay tests
    faults: object = None                 # FaultPlan injected every dispatch


@dataclasses.dataclass(frozen=True)
class ServeReport:
    """SLO-facing summary of one serving run."""

    n_sequences: int
    n_mem_requests: int
    n_dispatches: int
    n_steps: int
    p50_latency_us: float
    p99_latency_us: float
    mean_latency_us: float
    slo_latency_us: float
    slo_attainment: float        # fraction of sequences within the SLO
    pinned_accesses: int
    pinned_fast_hit_rate: float  # 0.0 when nothing was pinned
    pinned_slo: float
    pinned_slo_met: bool
    evictions: int
    refetches: int
    inflight_high_water: int
    live_seqs_high_water: int
    compile_count: int
    per_bucket: dict             # size -> dispatches/requests/service stats
    frames_retired: int = 0      # pages killed by endurance retirement
    fault_refetches: int = 0     # refetches forced by faults/retirement
    renegotiations: int = 0      # contracts re-pinned to the fast tier

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _ReqBuf:
    """FIFO of pending memory requests (struct-of-arrays, chunked)."""

    def __init__(self):
        self._parts: collections.deque[dict] = collections.deque()
        self.n = 0

    def append(self, part: dict) -> None:
        if len(part["page"]):
            self._parts.append(part)
            self.n += len(part["page"])

    def pop(self, d: int) -> dict:
        take: dict[str, list] = {f: [] for f in _FIELDS}
        got = 0
        while got < d:
            p = self._parts[0]
            k = len(p["page"])
            if k <= d - got:
                self._parts.popleft()
                for f in _FIELDS:
                    take[f].append(p[f])
                got += k
            else:
                need = d - got
                for f in _FIELDS:
                    take[f].append(p[f][:need])
                    p[f] = p[f][need:]
                got = d
        self.n -= d
        return {f: np.concatenate(v) if len(v) > 1 else v[0]
                for f, v in take.items()}


class _SlotStack:
    """LIFO of free sequence slots (slot 0 handed out first)."""

    def __init__(self, n: int):
        self.buf = np.arange(n - 1, -1, -1, dtype=np.int64)
        self.top = n

    def __len__(self):
        return self.top

    def pop(self, k: int) -> np.ndarray:
        take = self.buf[self.top - k:self.top][::-1].copy()
        self.top -= k
        return take

    def push(self, slots: np.ndarray) -> None:
        k = len(slots)
        self.buf[self.top:self.top + k] = slots
        self.top += k


class _Inflight:
    __slots__ = ("fetch", "rid", "pinned", "pages", "n_valid", "size")

    def __init__(self, fetch, rid, pinned, pages, n_valid, size):
        self.fetch, self.rid, self.pinned = fetch, rid, pinned
        self.pages, self.n_valid, self.size = pages, n_valid, size

    @property
    def outs(self) -> dict:
        """The dispatch's outputs as numpy arrays (waits for their copy)."""
        return self.fetch.get()


class ContinuousBatchingScheduler:
    """Drive an :class:`~repro_torch.Engine` with a continuous-batching
    request stream. ``submit`` sequences, then ``run()`` to completion
    (or ``step()``/``flush()`` manually), then ``report()``."""

    def __init__(self, engine: Engine, cfg: ServeConfig):
        self.engine = engine
        self.cfg = cfg
        self.buckets = BucketSpec(cfg.sorted_batch_sizes, engine.cfg.chunk)
        self.kv = PagedKVMap(engine.cfg, cfg.max_live_seqs,
                             cfg.max_pages_per_seq, cfg.pin_pages_per_seq,
                             cfg.free_low_frac, cfg.free_high_frac)
        self.carry = engine.init_state()
        # The fault plan goes to the engine's device once: a per-dispatch
        # copy from pageable memory would wait for the stream.
        self._faults = None if cfg.faults is None \
            else cfg.faults.to(engine.device)
        n = cfg.max_live_seqs
        self._free_slots = _SlotStack(n)
        self._slot_rid = np.full(n, -1, np.int64)
        self._slot_pages = np.zeros(n, np.int32)
        self._slot_tokens = np.zeros(n, np.int32)
        self._slot_left = np.zeros(n, np.int32)
        # FIFO arrival queue (rid == index into the per-sequence arrays).
        self._q_prompt = np.empty(0, np.int32)
        self._q_decode = np.empty(0, np.int32)
        self._q_head = 0
        self._first_issue = np.empty(0, np.int64)
        self._last_return = np.empty(0, np.int64)
        self._pending = _ReqBuf()
        self._inflight: collections.deque[_Inflight] = collections.deque()
        self._release_q: collections.deque = collections.deque()
        # Contracts pinned off the fast tier (spilled at admission, or
        # re-placed after a frame death landed them slow): (slot, idx,
        # rid), re-pinned to DRAM as fast pages free up.
        self._reneg: collections.deque = collections.deque()
        self._stamp_width = cfg.max_admit_per_step * cfg.pin_pages_per_seq
        self._rr = 0                  # round-robin service pointer
        self._step_no = 0
        self._built = 0               # requests appended to pending, ever
        self._dispatched = 0          # valid requests dispatched, ever
        self._n_decoding = 0          # live slots with decode work left
        self._n_occupied = 0
        self.refetches = 0
        self.fault_refetches = 0
        self.renegotiations = 0
        self._buckets_stats: dict[int, dict] = {}
        self.dispatch_log: list[tuple[int, int]] = []
        self.inflight_high_water = 0
        self.live_seqs_high_water = 0
        self.trace_log: list[Trace] = []    # valid requests, host (record)
        self.outs_log: list[dict] = []      # harvested outs (record)

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------
    def submit(self, prompt_pages, decode_tokens) -> np.ndarray:
        """Enqueue sequences (FIFO). ``prompt_pages[i]`` KV pages are
        prefilled at admission; ``decode_tokens[i]`` decode steps follow.
        Returns the assigned request ids."""
        pp = np.asarray(prompt_pages, np.int32).reshape(-1)
        dt = np.asarray(decode_tokens, np.int32).reshape(-1)
        if pp.shape != dt.shape:
            raise ValueError("prompt_pages and decode_tokens must match")
        floor = max(1, self.cfg.pin_pages_per_seq)
        if len(pp) and (int(pp.min()) < floor or int(dt.min()) < 1):
            raise ValueError(
                f"need prompt_pages >= {floor} (the pinned prefix) and "
                "decode_tokens >= 1 per sequence")
        if len(pp) and int(pp.max()) > self.cfg.max_pages_per_seq:
            raise ValueError("prompt exceeds max_pages_per_seq")
        rid0 = len(self._first_issue)
        self._q_prompt = np.concatenate([self._q_prompt, pp])
        self._q_decode = np.concatenate([self._q_decode, dt])
        k = len(pp)
        self._first_issue = np.concatenate(
            [self._first_issue, np.full(k, np.iinfo(np.int64).max)])
        self._last_return = np.concatenate(
            [self._last_return, np.full(k, -1, np.int64)])
        return np.arange(rid0, rid0 + k, dtype=np.int64)

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Dispatch every bucket (and the contract edits) once against a
        throwaway state, so ``Engine.compile_count`` is flat across the
        real run (on a card this also builds the chunk-step kernel). The
        serving state is untouched."""
        dev = self.engine.device
        st = self.engine.init_state()
        for s in self.buckets.sorted_batch_sizes:
            z = torch.zeros(s, dtype=torch.int32, device=dev)
            tr = Trace(page=z, offset=z,
                       is_write=torch.zeros(s, dtype=torch.bool, device=dev),
                       size=torch.full((s,), _LINE, dtype=torch.int32,
                                       device=dev))
            st = self.engine.run(tr, state=st, faults=self._faults).state
        if self.cfg.pin_pages_per_seq:
            w = self._stamp_width
            st = stamp_pin_pages(st, np.zeros(0, np.int32), width=w)
            st = release_pin_pages(st, np.zeros(0, np.int32), width=w)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step(self) -> int:
        """One scheduling step: decode service, admission, dispatch.
        Returns the number of memory requests built."""
        self._step_no += 1
        self._renegotiate_contracts()
        parts: list[dict] = []
        done = self._decode(parts)
        self._admit(parts)
        built = 0
        for p in parts:
            built += len(p["page"])
            self._pending.append(p)
        self._built += built
        if len(done):
            self._release_q.append((self._built, done))
        self._dispatch_ready()
        if built == 0 and (self._q_len() or self._release_q):
            # All slots are occupied by finished-but-unflushed sequences
            # (or nothing new fit): flush the sub-bucket tail so their
            # final requests dispatch and the slots recycle.
            self._flush_pending()
        return built

    def run(self) -> None:
        """Drive every submitted sequence to completion and harvest."""
        while self._q_len() or self._n_decoding:
            self.step()
        self.flush()

    def flush(self) -> None:
        """Dispatch the padded tail, harvest everything in flight, and
        process every completion."""
        self._flush_pending()
        while self._inflight:
            self._harvest_one()
        self._process_releases()

    # -- live status ----------------------------------------------------
    @property
    def pending(self) -> bool:
        """Work remains: queued arrivals or live decoding sequences."""
        return bool(self._q_len() or self._n_decoding)

    @property
    def queued(self) -> int:
        """Sequences submitted but not yet admitted."""
        return self._q_len()

    @property
    def live_seqs(self) -> int:
        """Slots currently occupied by admitted sequences."""
        return self._n_occupied

    @property
    def dispatches(self) -> int:
        """Batches dispatched to the engine so far."""
        return len(self.dispatch_log)

    @property
    def requests_dispatched(self) -> int:
        """Valid memory requests dispatched so far."""
        return self._dispatched

    # -- fault recovery -------------------------------------------------
    def _protected_pages(self) -> np.ndarray:
        """Pages referenced by built-but-undispatched requests. They must
        not be evicted, freed, or renegotiated away: the pending trace
        already names them, and recycling a named page would hand another
        sequence's data the same address."""
        parts = [p["page"] for p in self._pending._parts]
        if not parts:
            return np.empty(0, np.int32)
        return np.concatenate(parts)

    def _renegotiate_contracts(self) -> None:
        """Re-pin contracts stranded off the fast tier (§III-G
        renegotiation): whenever fast pages free up, the oldest stranded
        contract migrates onto one — old page released and freed, new
        page stamped — so a burst of spills or frame deaths degrades the
        pinned fast-hit rate only transiently."""
        if not self._reneg:
            return
        kv = self.kv
        nf = self.engine.cfg.n_fast_pages
        w = self._stamp_width
        prot = self._protected_pages()
        deferred = []
        while self._reneg and len(kv._stacks[FAST]):
            slot, idx, rid = self._reneg.popleft()
            if self._slot_rid[slot] != rid:
                continue                 # sequence finished; moot
            old = int(kv.page_of[slot, idx])
            if old < 0 or old < nf:
                continue                 # refetch pending, or already fast
            if len(prot) and old in prot:
                deferred.append((slot, idx, rid))
                continue                 # a pending request names it
            fresh = kv.alloc(1, hint=FAST)
            if self.cfg.pin_pages_per_seq:
                self.carry = release_pin_pages(
                    self.carry, np.array([old], np.int32), width=w)
            kv.page_of[slot, idx] = -1
            kv._free(np.array([old], np.int32))
            kv.assign(np.array([slot]), np.array([idx], np.int32), fresh,
                      self._step_no)
            if self.cfg.pin_pages_per_seq:
                self.carry = stamp_pin_pages(self.carry, fresh, width=w)
            self.renegotiations += 1
        self._reneg.extendleft(reversed(deferred))

    def _replace_contracts(self, slots: np.ndarray,
                           idxs: np.ndarray) -> None:
        """Re-place contract pages whose frames died: allocate fresh
        pages (fast-tier hint), stamp new pins, and queue any slow
        spills for renegotiation. The refetched contents count as
        fault refetches."""
        k = len(slots)
        if k == 0:
            return
        self.kv.maybe_evict(self._step_no, k,
                            protected=self._protected_pages())
        fresh = self.kv.alloc(k, hint=FAST)
        self.kv.assign(slots, idxs, fresh, self._step_no)
        if self.cfg.pin_pages_per_seq:
            self.carry = stamp_pin_pages(self.carry, fresh,
                                         width=self._stamp_width)
        nf = self.engine.cfg.n_fast_pages
        for s, i in zip(slots[fresh >= nf], idxs[fresh >= nf]):
            self._reneg.append((int(s), int(i), int(self._slot_rid[s])))
        self.fault_refetches += k

    def _recover_faults(self, rec: _Inflight) -> None:
        """Serving-level graceful degradation: retire pages the emulator
        killed this dispatch (the tombstone parked on the dead frame and
        its rescued swap partner — both conservatively dropped, ~2 pages
        per death), re-place dead contract pages immediately, and
        invalidate transiently-faulted KV pages so their owners refetch.
        """
        rp = np.asarray(rec.outs["retired_page"]).reshape(-1)
        tb = np.asarray(rec.outs["tombstone"]).reshape(-1)
        dead = np.concatenate([rp[rp >= 0], tb[tb >= 0]])
        if len(dead):
            live, slots, idxs = self.kv.retire_pages(dead)
            contract = idxs < self.cfg.pin_pages_per_seq
            self._replace_contracts(slots[contract], idxs[contract])
            # Non-contract pages refetch lazily on their next access.
        faulted = np.asarray(rec.outs["faulted"]).reshape(-1)[:rec.n_valid]
        if faulted.any():
            fp = np.unique(rec.pages[faulted])
            fp = fp[fp >= 0]
            # Contract pages refill in place (they are pinned to stay
            # put); dead/unowned pages are already handled above.
            fp = fp[~self.kv.dead[fp] & (self.kv.owner[fp] >= 0)
                    & ~self.kv.pinned[fp]]
            prot = self._protected_pages()
            if len(prot):
                fp = fp[~np.isin(fp, prot)]
            if len(fp):
                self.kv.page_of[self.kv.owner[fp],
                                self.kv.owner_idx[fp]] = -1
                self.kv._free(fp)
                self.fault_refetches += len(fp)

    # -- decode service -------------------------------------------------
    def _decode(self, parts: list[dict]) -> np.ndarray:
        cfg = self.cfg
        live = np.flatnonzero((self._slot_rid >= 0) & (self._slot_left > 0))
        if not len(live):
            return np.empty(0, np.int64)
        pos = int(np.searchsorted(live, self._rr))
        order = np.roll(live, -pos)
        W = cfg.window_pages
        cost = np.minimum(self._slot_pages[order], W) + 1
        cum = np.cumsum(cost)
        B = min(int(np.searchsorted(cum, self.buckets.max_size)) + 1,
                len(order))
        sv = order[:B]
        self._rr = int(order[B - 1] + 1) % cfg.max_live_seqs

        pages_sv = self._slot_pages[sv]
        w = np.minimum(pages_sv, W)
        col = np.arange(W, dtype=np.int32)
        idx = (pages_sv - w)[:, None] + col[None, :]
        colmask = col[None, :] < w[:, None]
        P = self.kv.page_of[sv[:, None], np.clip(idx, 0, cfg.max_pages_per_seq - 1)]
        P = np.where(colmask, P, -1)
        missing = (P < 0) & colmask
        self.kv.touch(P[colmask & ~missing], self._step_no)

        # New tail page when the current token starts a fresh page.
        need_new = (self._slot_tokens[sv] % cfg.positions_per_page == 0) \
            & (pages_sv < cfg.max_pages_per_seq)
        n_missing, n_new = int(missing.sum()), int(need_new.sum())
        self.kv.maybe_evict(self._step_no, n_missing + n_new,
                            protected=self._protected_pages())
        if n_missing:                       # refetch evicted window pages
            r, c = np.nonzero(missing)
            fresh = self.kv.alloc(n_missing, hint=SLOW)
            self.kv.assign(sv[r], idx[r, c], fresh, self._step_no)
            P[r, c] = fresh
            self.refetches += n_missing
        if n_new:
            t = sv[need_new]
            fresh = self.kv.alloc(n_new, hint=SLOW)
            self.kv.assign(t, self._slot_pages[t], fresh, self._step_no)
            self._slot_pages[t] += 1
        tail = self.kv.page_of[sv, self._slot_pages[sv] - 1]
        self.kv.touch(tail, self._step_no)

        # Row-major flatten: each slot's window reads then its token write.
        M = np.concatenate([P, tail[:, None]], axis=1)
        mask = np.concatenate([colmask, np.ones((B, 1), bool)], axis=1)
        flat_pages = M[mask].astype(np.int32)
        row_tok = self._slot_tokens[sv]
        off = ((row_tok % _LINES_PER_PAGE) * _LINE).astype(np.int32)
        offs = np.broadcast_to(off[:, None], mask.shape)[mask]
        is_w = np.broadcast_to(
            np.arange(W + 1)[None, :] == W, mask.shape)[mask]
        rid = np.repeat(self._slot_rid[sv], w + 1)
        parts.append({
            "page": flat_pages, "offset": offs, "is_write": is_w,
            "size": np.full(len(flat_pages), _LINE, np.int32),
            "rid": rid, "pinned": self.kv.pinned[flat_pages].copy()})

        self._slot_tokens[sv] += 1
        self._slot_left[sv] -= 1
        done = sv[self._slot_left[sv] == 0]
        self._n_decoding -= len(done)
        return done.astype(np.int64)

    # -- admission ------------------------------------------------------
    def _admit(self, parts: list[dict]) -> None:
        cfg = self.cfg
        k = min(len(self._free_slots), self._q_len(), cfg.max_admit_per_step)
        if k == 0:
            return
        h = self._q_head
        plen = self._q_prompt[h:h + k]
        # Memory-aware admission: a prompt is admitted only if it fits in
        # free-plus-evictable pages, with one decode page of headroom, so
        # eviction pressure comes from decode churn rather than a
        # pathological admission burst.
        protected = self._protected_pages()
        budget = self.kv.free_total + self.kv.evictable(self._step_no,
                                                        protected)
        k = int(np.searchsorted(np.cumsum(plen + 1), budget, side="right"))
        if k == 0:
            if self._n_occupied == 0:
                raise MemoryError(
                    f"prompt of {int(plen[0])} pages can never be "
                    "admitted: even an empty platform lacks the pages")
            return
        slots = self._free_slots.pop(k)
        plen = plen[:k]
        dec = self._q_decode[h:h + k]
        rids = np.arange(h, h + k, dtype=np.int64)
        self._q_head += k

        total = int(plen.sum())
        self.kv.maybe_evict(self._step_no, total, protected=protected)
        slot_rep = np.repeat(slots, plen)
        starts = np.cumsum(plen) - plen
        idx = np.arange(total, dtype=np.int32) - np.repeat(starts, plen)
        # §III-G hint discipline: only the contracted prefix carries the
        # fast-tier hint — the rest of the prompt starts slow and earns
        # promotion from the placement policy like any other page.
        pin_mask = idx < cfg.pin_pages_per_seq
        pages = np.empty(total, np.int32)
        pages[pin_mask] = self.kv.alloc(int(pin_mask.sum()), hint=FAST)
        pages[~pin_mask] = self.kv.alloc(int((~pin_mask).sum()), hint=SLOW)
        self.kv.assign(slot_rep, idx, pages, self._step_no)

        if cfg.pin_pages_per_seq:
            pin_pages = pages[pin_mask]
            self.carry = stamp_pin_pages(self.carry, pin_pages,
                                         width=self._stamp_width)
            # Contracts whose fast-tier hint spilled slow renegotiate
            # back onto DRAM as fast pages free up.
            nf = self.engine.cfg.n_fast_pages
            spill = pin_pages >= nf
            if spill.any():
                s_sp = slot_rep[pin_mask][spill]
                i_sp = idx[pin_mask][spill]
                r_sp = np.repeat(rids, plen)[pin_mask][spill]
                self._reneg.extend(
                    (int(s), int(i), int(r))
                    for s, i, r in zip(s_sp, i_sp, r_sp))

        ppw = cfg.prefill_writes_per_page
        pref_pages = np.repeat(pages, ppw)
        j = np.tile(np.arange(ppw, dtype=np.int32), total)
        parts.append({
            "page": pref_pages,
            "offset": ((j % _LINES_PER_PAGE) * _LINE).astype(np.int32),
            "is_write": np.ones(len(pref_pages), bool),
            "size": np.full(len(pref_pages), _LINE, np.int32),
            "rid": np.repeat(np.repeat(rids, plen), ppw),
            "pinned": self.kv.pinned[pref_pages].copy()})

        self._slot_rid[slots] = rids
        self._slot_pages[slots] = plen
        self._slot_tokens[slots] = 0
        self._slot_left[slots] = dec
        self._n_decoding += k
        self._n_occupied += k
        self.live_seqs_high_water = max(self.live_seqs_high_water,
                                        self._n_occupied)

    # -- dispatch & harvest ---------------------------------------------
    def _dispatch_ready(self) -> None:
        while True:
            d = self.buckets.get_dispatch_size(self._pending.n)
            if d is None:
                return
            self._dispatch(self._pending.pop(d), d, d)

    def _flush_pending(self) -> None:
        n = self._pending.n
        if n == 0:
            self._process_releases()
            return
        while True:          # full buckets first, then pad only the tail
            d = self.buckets.get_dispatch_size(self._pending.n)
            if d is None:
                break
            self._dispatch(self._pending.pop(d), d, d)
        n = self._pending.n
        if n:
            size = self.buckets.get_padded_batch_size(n)
            batch = self._pending.pop(n)
            pad = size - n
            for f in _FIELDS:
                z = np.zeros(pad, batch[f].dtype)
                batch[f] = np.concatenate([batch[f], z])
            self._dispatch(batch, size, n)

    def _dispatch(self, batch: dict, size: int, n_valid: int) -> None:
        if len(self._inflight) >= self.cfg.max_live_batches:
            self._harvest_one()
        dev = self.engine.device
        # One pinned host buffer and one copy for the four request vectors.
        packed = to_device(np.stack([batch["page"], batch["offset"],
                                     batch["is_write"].astype(np.int32),
                                     batch["size"]]), dev)
        trace = Trace(page=packed[0], offset=packed[1],
                      is_write=packed[2] != 0, size=packed[3])
        valid = None if n_valid == size else \
            torch.arange(size, device=dev) < n_valid
        state, outs = self.engine.run(trace, state=self.carry, valid=valid,
                                      faults=self._faults)
        self.carry = state
        fetch = Fetch(outs, self.engine.cfg.chunk)
        self._inflight.append(_Inflight(fetch, batch["rid"][:n_valid],
                                        batch["pinned"][:n_valid],
                                        batch["page"][:n_valid],
                                        n_valid, size))
        self.inflight_high_water = max(self.inflight_high_water,
                                       len(self._inflight))
        self.dispatch_log.append((size, n_valid))
        self._dispatched += n_valid
        if self.cfg.record_traces:
            self.trace_log.append(Trace(
                *(torch.from_numpy(batch[f][:n_valid].copy())
                  for f in ("page", "offset", "is_write", "size"))))
        self._process_releases()

    def _process_releases(self) -> None:
        while self._release_q and self._release_q[0][0] <= self._dispatched:
            _, slots = self._release_q.popleft()
            _, contracted = self.kv.release_slots(slots)
            if self.cfg.pin_pages_per_seq and len(contracted):
                w = self._stamp_width
                for i in range(0, len(contracted), w):
                    self.carry = release_pin_pages(
                        self.carry, contracted[i:i + w], width=w)
            self._slot_rid[slots] = -1
            self._slot_pages[slots] = 0
            self._free_slots.push(slots)
            self._n_occupied -= len(slots)

    def _harvest_one(self) -> None:
        rec = self._inflight.popleft()
        n = rec.n_valid
        returns = np.asarray(rec.outs["returns"])[:n].astype(np.int64)
        lat = np.asarray(rec.outs["latency"])[:n].astype(np.int64)
        dev = np.asarray(rec.outs["device"])[:n]
        np.minimum.at(self._first_issue, rec.rid, returns - lat)
        np.maximum.at(self._last_return, rec.rid, returns)
        pin = rec.pinned
        b = self._buckets_stats.setdefault(
            rec.size, {"dispatches": 0, "requests": 0, "padded": 0,
                       "service_lat_sum": 0.0, "service_lat_max": 0.0,
                       "pinned_accesses": 0, "pinned_fast_hits": 0})
        b["dispatches"] += 1
        b["requests"] += n
        b["padded"] += rec.size - n
        b["service_lat_sum"] += float(lat.sum())
        b["service_lat_max"] = max(b["service_lat_max"], float(lat.max()))
        b["pinned_accesses"] += int(pin.sum())
        b["pinned_fast_hits"] += int((pin & (dev == FAST)).sum())
        self._recover_faults(rec)
        if self.cfg.record_traces:
            self.outs_log.append(
                {k: np.asarray(v)[:n].copy() for k, v in rec.outs.items()})

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def _q_len(self) -> int:
        return len(self._q_prompt) - self._q_head

    def report(self) -> ServeReport:
        cfg = self.cfg
        done = self._last_return >= 0
        lat_us = (self._last_return[done]
                  - self._first_issue[done]) / 1e3
        if len(lat_us):
            p50 = float(np.percentile(lat_us, 50))
            p99 = float(np.percentile(lat_us, 99))
            mean = float(lat_us.mean())
            slo = float((lat_us <= cfg.slo_latency_us).mean())
        else:
            p50 = p99 = mean = 0.0
            slo = 1.0
        pa = sum(b["pinned_accesses"] for b in self._buckets_stats.values())
        ph = sum(b["pinned_fast_hits"] for b in self._buckets_stats.values())
        rate = ph / pa if pa else 0.0
        per_bucket = {}
        for size, b in sorted(self._buckets_stats.items()):
            per_bucket[size] = dict(b)
            per_bucket[size]["service_lat_mean_us"] = (
                b["service_lat_sum"] / b["requests"] / 1e3
                if b["requests"] else 0.0)
        return ServeReport(
            n_sequences=int(done.sum()),
            n_mem_requests=self._dispatched,
            n_dispatches=len(self.dispatch_log),
            n_steps=self._step_no,
            p50_latency_us=p50, p99_latency_us=p99, mean_latency_us=mean,
            slo_latency_us=cfg.slo_latency_us, slo_attainment=slo,
            pinned_accesses=pa, pinned_fast_hit_rate=rate,
            pinned_slo=cfg.pinned_slo, pinned_slo_met=rate >= cfg.pinned_slo
            if pa else True,
            evictions=self.kv.evictions, refetches=self.refetches,
            inflight_high_water=self.inflight_high_water,
            live_seqs_high_water=self.live_seqs_high_water,
            compile_count=self.engine.compile_count,
            per_bucket=per_bucket,
            frames_retired=self.kv.retired,
            fault_refetches=self.fault_refetches,
            renegotiations=self.renegotiations)
