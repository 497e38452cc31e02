"""Tiered paged KV-cache accounting — the HMMU managing a serving cache
(PyTorch port of ``repro.memtier.tiered_cache``).

The real application is the decoding LM; the design under test is a
KV-cache tier-management policy. KV pages (``positions_per_page``
consecutive cache slots of one layer group) are allocated in the
emulated hybrid space through the middleware API
(:class:`~repro_torch.core.table.HybridAllocator`, the paper's
driver+jemalloc analogue: fresh pages prefer the fast tier). Every
decode step's page-access stream goes through one :class:`Engine`
session on the carried (donated) state, which applies the configured
placement/migration policy, accounts every request's latency through the
pipeline model and keeps the paper's performance counters.

§III-G placement contracts: the first ``pin_pages_per_seq`` KV pages of
each sequence, which attention streams on every decode step, are
allocated with ``pin=True`` and pinned in the table's FLAGS lane to the
tier they occupy (``serve.contracts.stamp_pin_pages``), so no policy
evicts them. ``report()`` gives the pinned-page fast hit rate: the share
of accesses to contracted pages served from DRAM.

The session runs on ``cuda`` unless the caller passes ``device="cpu"``,
as :class:`Engine` does. Per step the host builds the stream, makes one
copy of it to the device, and reads back the clock and, while contracts
are live, the pages and devices of the step's requests.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import FAST, SLOW, EmulatorConfig, HybridAllocator, Trace
from ..core import counters
from ..engine import Engine
from ..serve.contracts import release_pin_pages, stamp_pin_pages
from ..serve.staging import to_device


@dataclasses.dataclass
class TierStats:
    steps: int = 0
    requests: int = 0
    est_cycles: int = 0
    pinned_accesses: int = 0
    pinned_fast_hits: int = 0


class TieredKVAccounting:
    """Tracks one model's decode-cache pages in the hybrid space."""

    def __init__(self, emu_cfg: EmulatorConfig, n_layers: int,
                 positions_per_page: int = 256,
                 bytes_per_position: int = 1024,
                 pin_pages_per_seq: int = 1, *, device=None):
        self.cfg = emu_cfg
        self.alloc = HybridAllocator(emu_cfg)
        self.n_layers = n_layers
        self.ppp = positions_per_page
        self.bpp = bytes_per_position
        self.pin_pages_per_seq = pin_pages_per_seq
        self.engine = Engine(emu_cfg, device=device)
        self.state = self.engine.init_state()
        # (seq_id, seq_page) -> flat page
        self._pages: dict[tuple, int] = {}
        self._handles: dict[tuple, int] = {}
        self._pinned: set[int] = set()
        self.stats = TierStats()

    def _page_for(self, seq_id: int, pos_page: int) -> int:
        key = (seq_id, pos_page)
        if key not in self._pages:
            # Fresh (hot) KV pages prefer the fast tier; the sequence's
            # first pin_pages_per_seq pages also get a pin contract,
            # stamped to the tier the page occupies (its DEVICE lane, or
            # where an in-flight swap moves it), on the device.
            pin = pos_page < self.pin_pages_per_seq
            handle, pages = self.alloc.alloc(1, hint=FAST, pin=pin)
            page = int(pages[0])
            self._pages[key] = page
            self._handles[key] = handle
            if pin:
                self.state = stamp_pin_pages(self.state, [page], width=1)
                self._pinned.add(page)
        return self._pages[key]

    def access_trace(self, seq_ids, kv_lens, windows=None) -> Trace:
        """One decode step's page-access stream, as one ``Trace`` on the
        engine's device.

        seq_ids: active sequence ids; kv_lens: tokens cached per
        sequence; windows: per-sequence attention windows (None = full).
        Reads touch every page the attention pass streams; the new
        token's page gets a write.
        """
        pages, offsets, writes = [], [], []
        for sid, klen, win in zip(
                seq_ids, kv_lens,
                windows if windows is not None else [None] * len(seq_ids)):
            first = 0 if win is None else max(0, (klen - win) // self.ppp)
            last = (klen - 1) // self.ppp
            for pp in range(first, last + 1):
                pages.append(self._page_for(sid, pp))
                offsets.append((pp % 4) * self.cfg.subblock)
                writes.append(False)
            pages.append(self._page_for(sid, last))
            offsets.append(((klen - 1) % self.ppp) * self.bpp
                           % self.cfg.page_size)
            writes.append(True)
        n = len(pages)
        packed = to_device(np.stack([
            np.asarray(pages, np.int32).reshape(n),
            np.asarray(offsets, np.int32).reshape(n),
            np.asarray(writes, np.int32).reshape(n),
            np.full(n, min(self.bpp, 4096), np.int32)]), self.engine.device)
        return Trace(page=packed[0], offset=packed[1],
                     is_write=packed[2] != 0, size=packed[3])

    def account(self, trace: Trace) -> dict:
        """Feed one step's stream through the HMMU session (incremental;
        the carried state is donated and moves forward in place)."""
        before = int(self.state.clock)
        self.state, outs = self.engine.run(trace, state=self.state)
        clock = int(self.state.clock)
        self.stats.steps += 1
        self.stats.requests += len(trace)
        self.stats.est_cycles = clock
        if self._pinned:
            pages, dev = torch.stack(
                [trace.page.to(self.engine.device), outs["device"]]
            ).cpu().numpy()
            pin = np.isin(pages, np.fromiter(self._pinned, np.int32))
            self.stats.pinned_accesses += int(pin.sum())
            self.stats.pinned_fast_hits += int((pin & (dev == FAST)).sum())
        return {"step_cycles": clock - before}

    def free_sequence(self, seq_id: int):
        for key in [k for k in self._pages if k[0] == seq_id]:
            page = self._pages[key]
            if page in self._pinned:
                # Release the §III-G contract with the allocation.
                self.state = release_pin_pages(self.state, [page], width=1)
                self._pinned.discard(page)
            self.alloc.free(self._handles.pop(key))
            del self._pages[key]

    def report(self) -> dict:
        summ = counters.summary(self.state.counters)
        pinned_hits = self.stats.pinned_fast_hits
        summ.update(est_total_cycles=self.stats.est_cycles,
                    migrations=int(self.state.dma.swaps_done),
                    steps=self.stats.steps,
                    requests=self.stats.requests,
                    fast_free=self.alloc.free_pages[FAST],
                    slow_free=self.alloc.free_pages[SLOW],
                    pinned_pages=len(self._pinned),
                    pinned_accesses=self.stats.pinned_accesses,
                    # 0.0, not nan, when no access reached a contracted
                    # page (a sequence can end before its first decode).
                    pinned_fast_hit_rate=(
                        pinned_hits / self.stats.pinned_accesses
                        if self.stats.pinned_accesses else 0.0))
        return summ
