"""Packed redirection-table store (PyTorch port of ``repro.core.table``).

All per-page metadata lives in ONE ``int32[n_pages, ROW_W]`` tensor —
the BRAM word the paper's redirection table serves per cycle. Lanes
(columns) of row ``i``:

    ======= ===========================================================
    lane    meaning
    ======= ===========================================================
    DEVICE  tier of page ``i`` (FAST=0 / SLOW=1)
    FRAME   frame of page ``i`` within its device
    HOTNESS aging access counter of page ``i`` (policy state)
    WEAR    writes absorbed by *slow frame* ``i`` (endurance histogram)
    OWNER   inverse map: page owning *fast frame* ``i`` (CLOCK victims)
    EPOCH   cycle at which row ``i``'s mapping last changed (0 = never)
    FLAGS   protection bitfield: PIN_FAST / PIN_SLOW / POISONED / RETIRED
    ======= ===========================================================

The layout, the flag bits and the saturation caps are those of the JAX
package; the CUDA kernels (``kernels/csrc``) hard-code the same numbers.
Functions that the JAX package wrote as pure updates (``decay_hotness``,
``set_flags``, ``clear_flags``) return a new tensor here too; only the
chunk step updates a table in place. The lane readers and updates take a
table [n_pages, ROW_W] or a stacked one [B, n_pages, ROW_W] (a leading
design-point axis, the JAX package's ``vmap``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import EmulatorConfig, FAST, SLOW
from .indexing import put_lane_, take_lane

ROW_W = 8
DEVICE, FRAME, HOTNESS, WEAR, OWNER, EPOCH, FLAGS = range(7)
_PAD = 7  # spare lane keeping the row a power-of-two width

LANES = ("device", "frame", "hotness", "wear", "owner", "epoch", "flags")

PIN_FAST = 1 << 0
PIN_SLOW = 1 << 1
POISONED = 1 << 2
RETIRED = 1 << 3
PINNED = PIN_FAST | PIN_SLOW
KNOWN_FLAGS = PIN_FAST | PIN_SLOW | POISONED | RETIRED

# HOTNESS and WEAR saturate at these caps instead of wrapping int32.
HOTNESS_CAP = 1 << 29
WEAR_CAP = 1 << 29


class TableRows(NamedTuple):
    """Unpacked view of table rows — one tensor per named lane."""
    device: torch.Tensor
    frame: torch.Tensor
    hotness: torch.Tensor
    wear: torch.Tensor
    owner: torch.Tensor
    epoch: torch.Tensor
    flags: torch.Tensor


def device(table: torch.Tensor) -> torch.Tensor:
    """Tier of each page. Works on [..., n, ROW_W] and on rows
    [..., ROW_W]."""
    return table[..., DEVICE]


def frame(table: torch.Tensor) -> torch.Tensor:
    return table[..., FRAME]


def hotness(table: torch.Tensor) -> torch.Tensor:
    return table[..., HOTNESS]


def wear(table: torch.Tensor) -> torch.Tensor:
    return table[..., WEAR]


def owner(table: torch.Tensor) -> torch.Tensor:
    return table[..., OWNER]


def epoch(table: torch.Tensor) -> torch.Tensor:
    return table[..., EPOCH]


def flags(table: torch.Tensor) -> torch.Tensor:
    return table[..., FLAGS]


def is_pinned(table: torch.Tensor) -> torch.Tensor:
    return (table[..., FLAGS] & PINNED) != 0


def is_poisoned(table: torch.Tensor) -> torch.Tensor:
    return (table[..., FLAGS] & POISONED) != 0


def is_retired(table: torch.Tensor) -> torch.Tensor:
    return (table[..., FLAGS] & RETIRED) != 0


def saturating_weights(targets: torch.Tensor, weights: torch.Tensor,
                       pre: torch.Tensor, cap: int) -> torch.Tensor:
    """Clip scatter-add ``weights`` so the lane at each target saturates
    at ``cap`` instead of wrapping: element ``i`` adds at most what is
    left of ``cap`` after the pre-value ``pre[i]`` and every *earlier*
    element aimed at the same slot. O(n^2) in the chunk width; along the
    last axis, per point of a leading point axis."""
    w = weights.to(torch.int32)
    n = w.shape[-1]
    i = torch.arange(n, dtype=torch.int32, device=w.device)
    same_earlier = (targets[..., None, :] == targets[..., :, None]) & \
        (i[None, :] < i[:, None])
    psum = torch.where(same_earlier, w[..., None, :], 0).sum(
        dim=-1, dtype=torch.int32)
    allow = cap - pre - psum
    return torch.minimum(allow.clamp_min(0), w)


def decay_hotness(table: torch.Tensor, shift) -> torch.Tensor:
    """The aging tick: arithmetic-shift every page's HOTNESS lane (``shift``
    an int, or one per point of a stacked table)."""
    shift = torch.as_tensor(shift, dtype=torch.int32, device=table.device)
    out = table.clone()
    out[..., HOTNESS] = table[..., HOTNESS] >> shift[..., None]
    return out


def swap_commit_lanes(k: torch.Tensor) -> torch.Tensor:
    """Lane ids of the DMA swap commit's delta pairs, by pair index ``k``:
    (DEVICE, FRAME, EPOCH, WEAR, FLAGS)."""
    lanes = torch.tensor([DEVICE, FRAME, EPOCH, WEAR, FLAGS],
                         dtype=torch.int32, device=k.device)
    return lanes[k.to(torch.int64)]


def set_flags(table: torch.Tensor, pages, bits: int) -> torch.Tensor:
    """OR ``bits`` into the FLAGS lane of ``pages`` (scenario side; for a
    stacked table, ``pages`` [B, k] per point)."""
    pages = torch.as_tensor(pages, dtype=torch.int32, device=table.device)
    return put_lane_(table.clone(), pages, FLAGS,
                     take_lane(table, pages, FLAGS) | bits)


def clear_flags(table: torch.Tensor, pages,
                bits: int = KNOWN_FLAGS) -> torch.Tensor:
    """Clear ``bits`` (default: all known bits) on ``pages``."""
    pages = torch.as_tensor(pages, dtype=torch.int32, device=table.device)
    return put_lane_(table.clone(), pages, FLAGS,
                     take_lane(table, pages, FLAGS) & ~bits)


def pack_rows(device, frame, hotness=None, wear=None, owner=None,
              epoch=None, flags=None) -> torch.Tensor:
    """Pack per-lane tensors into a table; unspecified lanes (and the pad
    lane) are zero. Inverse of :func:`unpack`."""
    device = torch.as_tensor(device, dtype=torch.int32)
    z = torch.zeros_like(device)
    lanes = [device, torch.as_tensor(frame, dtype=torch.int32)]
    for lane in (hotness, wear, owner, epoch, flags):
        lanes.append(z if lane is None
                     else torch.as_tensor(lane, dtype=torch.int32))
    lanes.append(z)  # _PAD
    return torch.stack(lanes, dim=-1)


def unpack(table: torch.Tensor) -> TableRows:
    """Split a packed table into named lanes (drops the pad lane)."""
    return TableRows(*(table[..., lane] for lane in range(len(LANES))))


def init_table(cfg: EmulatorConfig, n_fast_pages=None,
               pin_fast_fraction=None, device=None) -> torch.Tensor:
    """Initial packed table: the first ``n_fast_pages`` pages map to DRAM
    frames, the rest to NVM frames; fast frame ``f`` starts owned by page
    ``f``. ``n_fast_pages`` (int32) and ``pin_fast_fraction`` (float32)
    may be 0-dim tensors (``RuntimeParams`` fields); the pinned prefix is
    ``floor(float32(frac) * float32(nf))``, computed in float32 as the
    JAX package does. Given as [B, 1] tensors they give B tables,
    [B, n_pages, 8]."""
    n = cfg.n_pages
    nf = cfg.n_fast_pages if n_fast_pages is None else n_fast_pages
    frac = (cfg.pin_fast_fraction if pin_fast_fraction is None
            else pin_fast_fraction)
    if isinstance(nf, torch.Tensor):
        device = nf.device if device is None else device
    nf = torch.as_tensor(nf, dtype=torch.int32, device=device)
    frac = torch.as_tensor(frac, dtype=torch.float32, device=device)
    ar = torch.arange(n, dtype=torch.int32, device=device)
    dev = torch.where(ar < nf, FAST, SLOW).to(torch.int32)
    frm = torch.where(ar < nf, ar, ar - nf).to(torch.int32)
    n_pin = torch.floor(frac * nf.to(torch.float32)).to(torch.int32)
    flg = torch.where(ar < n_pin, PIN_FAST, 0).to(torch.int32)
    return pack_rows(dev, frm, owner=ar.expand_as(dev), flags=flg)


def check_table(cfg: EmulatorConfig, table,
                n_fast_pages: int | None = None) -> None:
    """Invariants of a packed table (numpy; raises on violation): the
    (device, frame) mapping is a bijection onto device frames, OWNER is
    the inverse of the fast-tier mapping, FLAGS carries only known bits
    consistent with DEVICE, RETIRED implies POISONED, no page is both
    PINNED and POISONED, and 0 <= HOTNESS, WEAR <= their caps."""
    nf = cfg.n_fast_pages if n_fast_pages is None else int(n_fast_pages)
    ns = cfg.n_pages - nf
    if isinstance(table, torch.Tensor):
        table = table.detach().cpu().numpy()
    table = np.asarray(table)
    dev = table[..., DEVICE]
    frm = table[..., FRAME]
    fast_frames = np.sort(frm[dev == FAST])
    slow_frames = np.sort(frm[dev == SLOW])
    if fast_frames.size != nf or \
            not np.array_equal(fast_frames, np.arange(nf)):
        raise AssertionError("fast-frame mapping is not a bijection")
    if slow_frames.size != ns or \
            not np.array_equal(slow_frames, np.arange(ns)):
        raise AssertionError("slow-frame mapping is not a bijection")
    own = table[..., OWNER]
    for f in range(nf):
        p = own[f]
        if not 0 <= p < cfg.n_pages or dev[p] != FAST or frm[p] != f:
            raise AssertionError(
                f"OWNER lane stale: fast frame {f} claims page {p}")
    flg = table[..., FLAGS]
    bad = np.nonzero(flg & ~KNOWN_FLAGS)[0]
    if bad.size:
        raise AssertionError(
            f"unknown FLAGS bits on page {bad[0]}: {flg[bad[0]]:#x}")
    both = np.nonzero((flg & PINNED) == PINNED)[0]
    if both.size:
        raise AssertionError(
            f"page {both[0]} pinned to both tiers ({flg[both[0]]:#x})")
    stray = np.nonzero(((flg & PIN_FAST) != 0) & (dev != FAST))[0]
    if stray.size:
        raise AssertionError(
            f"PIN_FAST page {stray[0]} migrated to the slow tier")
    stray = np.nonzero(((flg & PIN_SLOW) != 0) & (dev != SLOW))[0]
    if stray.size:
        raise AssertionError(
            f"PIN_SLOW page {stray[0]} migrated to the fast tier")
    orphan = np.nonzero(((flg & RETIRED) != 0) & ((flg & POISONED) == 0))[0]
    if orphan.size:
        raise AssertionError(
            f"RETIRED page {orphan[0]} is not POISONED ({flg[orphan[0]]:#x})")
    hot = np.nonzero(((flg & PINNED) != 0) & ((flg & POISONED) != 0))[0]
    if hot.size:
        raise AssertionError(
            f"page {hot[0]} is pinned on a poisoned frame "
            f"({flg[hot[0]]:#x})")
    for lane, cap, name in ((HOTNESS, HOTNESS_CAP, "HOTNESS"),
                            (WEAR, WEAR_CAP, "WEAR")):
        vals = table[..., lane]
        bad = np.nonzero((vals < 0) | (vals > cap))[0]
        if bad.size:
            raise AssertionError(
                f"{name} lane of row {bad[0]} outside [0, {name}_CAP]: "
                f"{vals[bad[0]]} (wrapped or unsaturated accumulator)")


class HybridAllocator:
    """Host-side allocator over the flat hybrid space with placement hints
    (numpy; a copy of the JAX package's).

    Mirrors the paper's driver+jemalloc middleware: allocations are ranges
    of flat pages; ``hint`` expresses device preference honoured on a
    best-effort basis (like the extended malloc API of §III-G).
    """

    def __init__(self, cfg: EmulatorConfig):
        self.cfg = cfg
        # Free pools of flat page numbers whose *initial* mapping is on the
        # given device, popped from the end (lowest page first).
        self._free = {
            FAST: list(range(cfg.n_fast_pages - 1, -1, -1)),
            SLOW: list(range(cfg.n_pages - 1, cfg.n_fast_pages - 1, -1)),
        }
        self._owned: dict[int, list[int]] = {}
        self._pinned: dict[int, list[int]] = {}
        self._retired: set[int] = set()
        self._next_handle = 0

    def _pool_of(self, page: int) -> int:
        return FAST if page < self.cfg.n_fast_pages else SLOW

    def alloc(self, n_pages: int, hint: int = FAST,
              pin: bool = False) -> tuple[int, np.ndarray]:
        """Allocate ``n_pages`` flat pages, preferring the ``hint`` device
        and spilling to the other. Returns (handle, int32 page numbers);
        raises ``MemoryError`` (taking nothing) when the pools are short.

        ``pin=True`` is the strong form of the hint: each page is pinned
        to the device it landed on (PIN_FAST below the tier boundary,
        PIN_SLOW above) by :meth:`apply_flags`, until :meth:`free`."""
        other = SLOW if hint == FAST else FAST
        take = []
        for pool in (self._free[hint], self._free[other]):
            while pool and len(take) < n_pages:
                take.append(pool.pop())
        if len(take) < n_pages:
            for p in take:  # roll back
                self._free[self._pool_of(p)].append(p)
            raise MemoryError(f"out of hybrid memory ({n_pages} pages)")
        handle = self._next_handle
        self._next_handle += 1
        self._owned[handle] = take
        if pin:
            self._pinned[handle] = take
        return handle, np.asarray(take, np.int32)

    def free(self, handle: int) -> None:
        """Return a handle's pages to their pools (retired pages excepted)
        and drop its pins."""
        self._pinned.pop(handle, None)
        for p in self._owned.pop(handle):
            if p in self._retired:
                continue  # dead frames never return to the free pools
            self._free[self._pool_of(p)].append(p)

    def retire(self, pages) -> None:
        """Take ``pages`` out of circulation for good (their frames died):
        free copies leave the pools now, owned copies when their handle is
        freed."""
        dead = {int(p) for p in np.atleast_1d(np.asarray(pages, np.int64))}
        self._retired.update(dead)
        for d in (FAST, SLOW):
            self._free[d] = [p for p in self._free[d] if p not in dead]

    @property
    def retired_pages(self) -> set[int]:
        return set(self._retired)

    def apply_flags(self, table: torch.Tensor) -> torch.Tensor:
        """Stamp the pin bits of every live pinned allocation into
        ``table``'s FLAGS lane, in place (the tier from each page's
        *initial* placement, where it still is before emulation moves
        anything). Returns ``table``."""
        nf = self.cfg.n_fast_pages
        pinned = [p for ps in self._pinned.values() for p in ps]
        for pages, bit in (([p for p in pinned if p < nf], PIN_FAST),
                           ([p for p in pinned if p >= nf], PIN_SLOW)):
            if pages:
                table.copy_(set_flags(table, np.asarray(pages, np.int32),
                                      bit))
        return table

    @property
    def free_pages(self) -> dict[int, int]:
        return {d: len(v) for d, v in self._free.items()}
