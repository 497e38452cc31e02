"""Data placement / migration policies (paper §III-A), PyTorch port of
``repro.core.policies``.

A policy examines the chunk's access stream plus the packed table and
proposes at most one page swap for the single DMA engine::

    propose(cfg, params, table, ptr, pages, is_write, valid)
        -> (want: bool, slow_page: int32, fast_victim: int32, new_ptr)

for one design point, or for B of them along a leading point axis (the
table [B, n_pages, 8], ``params`` and ``ptr`` [B], the chunk [B, n]; the
proposal [B]), each point on its own table. An arg-max or arg-min keeps
the first index on a tie, as JAX's does.

Victims come from a CLOCK pointer over DRAM frames (the OWNER lane);
``hotness_global`` is the idealised whole-table reference. ``new_ptr``
commits only when a wanted swap starts, or unconditionally when nothing
is wanted (the pin-skip channel) — the emulator enforces that contract.

A policy may declare a keyword parameter ``min_wear`` (as ``wear_level``
does): the chunk step passes the emulator's global min-wear register to
it. New policies register with ``@register("name")``; an ``Engine``
snapshots the module dict into a frozen :class:`PolicyRegistry` of
names AND function objects, so a later registration, or a re-registration
of a name, changes future sessions only.

The six built-in policies are registered in the JAX package's order, so
a policy's index is the same ``policy_id`` in both packages (a user
policy registered in the same order in both gets the same id too). The
CUDA chunk-step kernel compiles the six built-ins in: an entry of a
registry is built-in exactly when its function object is one of the six
taken at import (:func:`builtin_id`), whatever its name. A user policy
runs on the CPU and on the card's scan path (``chunk_step_kernel="off"``);
the kernel route refuses it by name.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import table as table_lib
from .config import FAST, SLOW
from .indexing import take_lane, take_rows

POLICIES: dict[str, Callable] = {}


def register(name: str):
    """Register the decorated policy under ``name`` (a re-registration
    replaces the module dict's entry; existing snapshots keep theirs)."""
    def deco(fn):
        POLICIES[name] = fn
        return fn
    return deco


def get(name: str) -> Callable:
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; have {sorted(POLICIES)}")
    return POLICIES[name]


def policy_id(name: str) -> int:
    """Index of ``name`` in registration order — the
    ``RuntimeParams.policy_id`` of the full registry."""
    get(name)
    return list(POLICIES).index(name)


def builtin_id(fn: Callable) -> int:
    """Index of ``fn`` among the six built-in policies — the branch the
    chunk-step kernel runs — by identity of the function object; -1 for
    any other function, whatever name it was registered under."""
    for i, b in enumerate(_BUILTINS):
        if fn is b:
            return i
    return -1


@dataclasses.dataclass(frozen=True)
class PolicyRegistry:
    """An immutable, ordered ``name -> policy fn`` snapshot — what a
    ``policy_id`` indexes. Dispatch clamps the id into range, as the JAX
    package's ``lax.switch`` does. Hashable: two snapshots of an
    unchanged module dict compare equal."""

    names: tuple[str, ...]
    fns: tuple[Callable, ...]

    def __post_init__(self):
        if len(self.names) != len(self.fns):
            raise ValueError("names and fns length mismatch")
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"duplicate policy names: {self.names}")

    @classmethod
    def snapshot(cls, names=None) -> "PolicyRegistry":
        """Snapshot the module dict: every registered policy in
        registration order when ``names`` is None, else the named subset
        in the given order."""
        names = tuple(POLICIES if names is None else names)
        return cls(names, tuple(get(n) for n in names))

    @property
    def builtin_ids(self) -> tuple[int, ...]:
        """Built-in index of each entry (the map the kernel switches on),
        -1 for a user policy (:func:`builtin_id`)."""
        return tuple(builtin_id(f) for f in self.fns)

    def user_policies(self, ids=None) -> tuple[str, ...]:
        """Names of the entries that are not built-in, among the entries
        ``ids`` (registry indices) or among all of them."""
        ids = range(len(self)) if ids is None else ids
        builtin = self.builtin_ids
        return tuple(self.names[i] for i in sorted(set(ids))
                     if builtin[i] < 0)

    def index(self, name: str) -> int:
        if name not in self.names:
            raise KeyError(
                f"policy {name!r} is not in this registry; have {self.names}")
        return self.names.index(name)

    def subset(self, names) -> "PolicyRegistry":
        """A restricted registry carrying the same snapshotted
        functions."""
        names = tuple(names)
        return PolicyRegistry(names,
                              tuple(self.fns[self.index(n)] for n in names))

    def __contains__(self, name) -> bool:
        return name in self.names

    def __len__(self) -> int:
        return len(self.names)

    def __iter__(self):
        return iter(self.names)


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis of a bool mask, 0 when
    there is none (JAX's ``argmax`` over a bool vector)."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def pick(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``x[..., j]``: each point's element ``j`` (int64, as an arg-max
    gives it) of its last axis."""
    return x.gather(-1, j[..., None])[..., 0]


def _chunk_candidate(table, pages, valid, extra_mask=None):
    """Hottest slow-resident page among this chunk's accesses; pinned
    pages and retirement tombstones are never candidates. Ties go to the
    first request."""
    rows = take_rows(table, pages)
    ok = valid & (table_lib.device(rows) == SLOW) & \
        ~table_lib.is_pinned(rows) & ~table_lib.is_retired(rows)
    if extra_mask is not None:
        ok = ok & extra_mask
    heat = torch.where(ok, table_lib.hotness(rows), -1)
    j = torch.argmax(heat, dim=-1)
    return pick(pages, j), pick(heat, j)


# CLOCK pin-skip lookahead: frames examined per chunk from the pointer.
CLOCK_WINDOW = 8


def _clock_victim(table, ptr, nf):
    """First eligible CLOCK victim within ``CLOCK_WINDOW`` frames of the
    pointer (pinned owners and tombstones are stepped over). Returns
    ``(victim_page, found, skip)``."""
    offs = torch.arange(CLOCK_WINDOW, dtype=torch.int32, device=table.device)
    frames = (ptr[..., None] + offs) % nf[..., None]
    owners = take_lane(table, frames, table_lib.OWNER)
    rows = take_rows(table, owners)
    pinned = table_lib.is_pinned(rows) | table_lib.is_retired(rows)
    first = torch.argmin(pinned.to(torch.int32), dim=-1)  # first False, else 0
    found = ~pick(pinned, first)
    victim = pick(owners, first)
    skip = torch.where(found, first.to(torch.int32), CLOCK_WINDOW)
    return victim, found, skip


@register("static")
def static_policy(cfg, params, table, ptr, pages, is_write, valid):
    """Placement fixed at initialization; never migrate."""
    z = torch.zeros(ptr.shape, dtype=torch.int32, device=table.device)
    return torch.zeros(ptr.shape, dtype=torch.bool, device=table.device), \
        z, z, ptr


@register("hotness")
def hotness_policy(cfg, params, table, ptr, pages, is_write, valid):
    """Promote the hottest slow page seen in this chunk once it crosses
    ``hot_threshold``; victim = CLOCK pointer over DRAM frames, skipped
    if the victim is hotter than the candidate."""
    cand, heat = _chunk_candidate(table, pages, valid)
    victim, vfound, skip = _clock_victim(table, ptr, params.n_fast_pages)
    want = vfound & (heat >= params.hot_threshold) & \
        (heat > take_lane(table, victim, table_lib.HOTNESS))
    new_ptr = (ptr + skip + want.to(torch.int32)) % params.n_fast_pages
    return want, cand, victim, new_ptr


@register("write_bias")
def write_bias_policy(cfg, params, table, ptr, pages, is_write, valid):
    """The ``hotness`` rule; the chunk step weights this policy's writes
    by ``write_weight`` when it accumulates hotness."""
    return hotness_policy(cfg, params, table, ptr, pages, is_write, valid)


@register("stream")
def stream_policy(cfg, params, table, ptr, pages, is_write, valid):
    """Detect a dominant small stride in the chunk's page stream and
    pre-promote the stream's next page; else the hotness rule."""
    deltas = torch.where(valid[..., 1:] & valid[..., :-1],
                         pages[..., 1:] - pages[..., :-1], 0)
    span = 4  # recognise strides in [-span, span] \ {0}
    in_range = (deltas.abs() <= span) & (deltas != 0)
    hist = torch.zeros(*ptr.shape, 2 * span + 1, dtype=torch.int32,
                       device=table.device)
    hist.scatter_add_(-1, (deltas + span).clamp(0, 2 * span).to(torch.int64),
                      in_range.to(torch.int32))
    stride = torch.argmax(hist, dim=-1).to(torch.int32) - span
    strength = hist.amax(dim=-1)
    streaming = strength > (pages.shape[-1] // 4)

    n = pages.shape[-1]
    order = torch.arange(n, dtype=torch.int32, device=table.device)
    last = pick(pages, torch.argmax(torch.where(valid, order, -1), dim=-1))
    target = (last + stride).clamp(0, table.shape[-2] - 1)
    target_row = take_rows(table, target)
    target_is_slow = (table_lib.device(target_row) == SLOW) & \
        ~table_lib.is_pinned(target_row) & ~table_lib.is_retired(target_row)

    hw, hc, _, _ = hotness_policy(cfg, params, table, ptr, pages, is_write,
                                  valid)
    victim, vfound, skip = _clock_victim(table, ptr, params.n_fast_pages)
    want_stream = streaming & target_is_slow & vfound
    want = want_stream | hw
    cand = torch.where(want_stream, target, hc)
    new_ptr = (ptr + skip + want.to(torch.int32)) % params.n_fast_pages
    return want, cand, victim, new_ptr


@register("hotness_global")
def hotness_global_policy(cfg, params, table, ptr, pages, is_write, valid):
    """Idealized reference: global hottest-slow / coldest-fast scan."""
    dev = table_lib.device(table)
    hot = table_lib.hotness(table)
    pinned = table_lib.is_pinned(table) | table_lib.is_retired(table)
    heat_all = torch.where((dev == SLOW) & ~pinned, hot, -1)
    cand = torch.argmax(heat_all, dim=-1)
    heat = pick(heat_all, cand)
    cold = torch.where((dev == FAST) & ~pinned, hot, 2 ** 30)
    victim = torch.argmin(cold, dim=-1)
    want = (heat >= params.hot_threshold) & (heat > pick(hot, victim))
    return want, cand.to(torch.int32), victim.to(torch.int32), ptr


@register("wear_level")
def wear_level_policy(cfg, params, table, ptr, pages, is_write, valid,
                      min_wear=None):
    """The hotness rule with a wear-aware demotion destination: skip
    candidates whose slow frame has absorbed more than ``wear_slack``
    writes beyond ``min_wear`` (the emulator's global min-wear register;
    None falls back to the chunk-local floor)."""
    rows = take_rows(table, pages)
    slow = valid & (table_lib.device(rows) == SLOW)
    frm = table_lib.frame(rows)
    frame_wear = take_lane(table, torch.where(slow, frm, 0), table_lib.WEAR)
    if min_wear is None:
        wmin = torch.where(slow, frame_wear, 2 ** 30).amin(dim=-1)
    else:
        wmin = min_wear
    fresh = frame_wear <= (wmin + params.wear_slack)[..., None]
    cand, cheat = _chunk_candidate(table, pages, valid, extra_mask=fresh)
    victim, vfound, skip = _clock_victim(table, ptr, params.n_fast_pages)
    want = vfound & (cheat >= params.hot_threshold) & \
        (cheat > take_lane(table, victim, table_lib.HOTNESS))
    new_ptr = (ptr + skip + want.to(torch.int32)) % params.n_fast_pages
    return want, cand, victim, new_ptr


# The built-in policies' function objects, taken at import: what
# ``builtin_id`` compares against, so a function re-registered under a
# built-in name is still a user policy.
_BUILTINS: tuple[Callable, ...] = tuple(POLICIES.values())
