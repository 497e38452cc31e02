"""Vectorized KV-page bookkeeping for serving-scale sequence counts
(PyTorch port of ``repro.serve.kv``; host-side numpy, as there).

The JAX package's ``memtier.TieredKVAccounting`` keeps per-page Python
dicts — fine for a handful of model-coupled sequences, hopeless for 100k
concurrent ones. ``PagedKVMap`` is the same middleware role (the paper's
kernel-module + jemalloc analogue over the flat hybrid space) rebuilt on
numpy arrays: free lists are stacks with a top pointer, the page->owner map and
the LRU clock are flat arrays, and every operation — allocation,
assignment, release, eviction — is a batched array op, so the host-side
cost of a scheduler step is O(pages touched), not O(python objects).

Eviction models the serving stack swapping cold KV pages out to host
memory under pressure: when the free pool drops below the low watermark,
the coldest unpinned pages (oldest ``last_access`` stamp, never a page
touched this step, never a contracted page, never a page referenced by a
built-but-undispatched request — the ``protected`` set) are released
back to the allocator until the high watermark is restored. A sequence
whose evicted page is needed again re-allocates it (a *refetch*, counted
by the scheduler) — with windowed attention the candidates are precisely
the pages the attention pass will never stream again, so refetches
indicate an undersized window or an overcommitted tier.

Endurance retirement: :meth:`PagedKVMap.retire_pages` takes pages the
emulator reported dead (a retired frame's tombstone and its rescued
counterpart — the serving layer conservatively kills both) permanently
out of circulation. Dead pages are compacted out of the free stacks
eagerly and ``_free`` silently drops them, so a retired page id is never
handed out again; live owners are detached so the next access refetches
onto a healthy page.
"""
from __future__ import annotations

import numpy as np

from ..core import FAST, SLOW, EmulatorConfig

_NEVER = np.iinfo(np.int64).max


class _Stack:
    """A fixed-capacity LIFO of page numbers (vector push/pop)."""

    def __init__(self, pages: np.ndarray):
        self.buf = np.asarray(pages, np.int32).copy()
        self.top = len(self.buf)

    def __len__(self) -> int:
        return self.top

    def pop(self, k: int) -> np.ndarray:
        take = self.buf[self.top - k:self.top][::-1].copy()
        self.top -= k
        return take

    def push(self, pages: np.ndarray) -> None:
        k = len(pages)
        self.buf[self.top:self.top + k] = pages
        self.top += k


class PagedKVMap:
    """Flat-space page allocator + per-sequence page table + LRU clock."""

    def __init__(self, cfg: EmulatorConfig, max_live_seqs: int,
                 max_pages_per_seq: int, pin_pages_per_seq: int = 1,
                 free_low_frac: float = 0.02, free_high_frac: float = 0.04):
        n, nf = cfg.n_pages, cfg.n_fast_pages
        self.cfg = cfg
        self.pin_pages = pin_pages_per_seq
        # Initial-placement pools, allocation order matching the JAX
        # package's core.table.HybridAllocator (page 0 first).
        self._stacks = {FAST: _Stack(np.arange(nf - 1, -1, -1)),
                        SLOW: _Stack(np.arange(n - 1, nf - 1, -1))}
        self.page_of = np.full((max_live_seqs, max_pages_per_seq), -1,
                               np.int32)
        self.owner = np.full(n, -1, np.int32)      # slot owning each page
        self.owner_idx = np.full(n, -1, np.int32)  # page index within seq
        self.pinned = np.zeros(n, bool)
        self.dead = np.zeros(n, bool)                    # retired frames
        self.last_access = np.full(n, _NEVER, np.int64)  # free = _NEVER
        self.low_mark = int(free_low_frac * n)
        self.high_mark = max(int(free_high_frac * n), self.low_mark + 1)
        self.evictions = 0
        self.retired = 0

    @property
    def free_total(self) -> int:
        return len(self._stacks[FAST]) + len(self._stacks[SLOW])

    @property
    def free_pages(self) -> dict[int, int]:
        return {d: len(s) for d, s in self._stacks.items()}

    def alloc(self, k: int, hint: int = FAST) -> np.ndarray:
        """Allocate ``k`` pages preferring the hinted tier's initial
        placement, spilling to the other (§III-G best-effort hints)."""
        if k == 0:
            return np.empty(0, np.int32)
        other = SLOW if hint == FAST else FAST
        a = min(k, len(self._stacks[hint]))
        if k - a > len(self._stacks[other]):
            raise MemoryError(
                f"out of hybrid memory: want {k} pages, "
                f"free {self.free_total} (eviction exhausted?)")
        pages = self._stacks[hint].pop(a)
        if k > a:
            pages = np.concatenate([pages, self._stacks[other].pop(k - a)])
        return pages

    def assign(self, slots: np.ndarray, idx: np.ndarray,
               pages: np.ndarray, step: int) -> None:
        """Record ``pages`` as page ``idx`` of sequence slot ``slots``."""
        self.page_of[slots, idx] = pages
        self.owner[pages] = slots
        self.owner_idx[pages] = idx
        self.pinned[pages] = idx < self.pin_pages
        self.last_access[pages] = step

    def touch(self, pages: np.ndarray, step: int) -> None:
        self.last_access[pages] = step

    def release_slots(self, slots: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Free every page of the given sequence slots. Returns
        ``(all_pages, contracted_pages)`` — the latter still carry pin
        bits in the emulated table and must be released there too."""
        rows = self.page_of[slots]                       # [k, max_pages]
        pages = rows[rows >= 0]
        pinned = pages[self.pinned[pages]]
        self.page_of[slots] = -1
        self._free(pages)
        return pages, pinned

    def retire_pages(self, pages: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Take ``pages`` permanently out of circulation (their emulated
        frames died). Free-stack copies are compacted away; live owners
        are detached (their ``page_of`` entry becomes -1, triggering a
        refetch on next access). Returns ``(live, slots, idxs)`` — the
        subset that was owned when it died, with each page's owning slot
        and page index, so the scheduler can re-place contract pages."""
        pages = np.asarray(pages, np.int32).reshape(-1)
        pages = np.unique(pages[pages >= 0])
        pages = pages[~self.dead[pages]]
        if len(pages) == 0:
            e = np.empty(0, np.int32)
            return e, e, e
        self.dead[pages] = True
        self.retired += len(pages)
        for s in self._stacks.values():
            keep = s.buf[:s.top][~self.dead[s.buf[:s.top]]]
            s.buf[:len(keep)] = keep
            s.top = len(keep)
        live = pages[self.owner[pages] >= 0]
        slots = self.owner[live].copy()
        idxs = self.owner_idx[live].copy()
        self.page_of[slots, idxs] = -1
        self.owner[live] = -1
        self.owner_idx[live] = -1
        self.pinned[live] = False
        self.last_access[pages] = _NEVER
        return live, slots, idxs

    def _free(self, pages: np.ndarray) -> None:
        pages = pages[~self.dead[pages]]   # retired frames never return
        if len(pages) == 0:
            return
        self.owner[pages] = -1
        self.owner_idx[pages] = -1
        self.pinned[pages] = False
        self.last_access[pages] = _NEVER
        nf = self.cfg.n_fast_pages
        fast = pages[pages < nf]
        if len(fast):
            self._stacks[FAST].push(fast)
        slow = pages[pages >= nf]
        if len(slow):
            self._stacks[SLOW].push(slow)

    def _evict_cand(self, step: int,
                    protected: np.ndarray | None) -> np.ndarray:
        cand = (self.owner >= 0) & ~self.pinned & (self.last_access < step)
        if protected is not None and len(protected):
            cand[protected] = False
        return cand

    def evictable(self, step: int,
                  protected: np.ndarray | None = None) -> int:
        """Pages eviction could reclaim right now: allocated, unpinned,
        not touched this step, and not in the ``protected`` set."""
        return int(self._evict_cand(step, protected).sum())

    def maybe_evict(self, step: int, extra_needed: int = 0,
                    protected: np.ndarray | None = None) -> np.ndarray:
        """Evict cold pages when free pages dip under the low watermark
        (plus any immediately-needed allocation). Victims are the oldest
        unpinned allocated pages not touched this step and not in
        ``protected`` (pages referenced by built-but-undispatched
        requests — evicting one would recycle a page id an already-built
        trace still names); eviction stops at the high watermark or when
        candidates run out. Returns the evicted pages (their owners'
        ``page_of`` entries become -1)."""
        want_free = self.low_mark + extra_needed
        if self.free_total >= want_free:
            return np.empty(0, np.int32)
        target = max(self.high_mark + extra_needed - self.free_total, 0)
        cand = self._evict_cand(step, protected)
        n_cand = int(cand.sum())
        k = min(target, n_cand)
        if k == 0:
            return np.empty(0, np.int32)
        age = np.where(cand, self.last_access, _NEVER)
        victims = np.argpartition(age, k - 1)[:k].astype(np.int32)
        self.page_of[self.owner[victims], self.owner_idx[victims]] = -1
        self._free(victims)
        self.evictions += k
        return victims
