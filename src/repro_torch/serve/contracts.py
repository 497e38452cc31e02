"""§III-G pin-contract lifecycle on the packed table (PyTorch port of
``repro.serve.contracts``).

A pin contract nails a latency-critical KV page to the tier it actually
occupies: ``PIN_FAST`` below the tier boundary, ``PIN_SLOW`` where the
allocation spilled. The bit must agree with the page's *current* DEVICE
lane — not its id-boundary tier (migration may have moved a recycled
page since init) — and, when the page is a member of the DMA engine's
in-flight swap, with the tier that swap commits it to (``page_a``
promotes to FAST, ``page_b`` demotes to SLOW; the swap commits
unconditionally, so pinning the pre-swap tier would break the
pin<->DEVICE invariant one chunk later). A page whose frame is dying or
dead (POISONED or RETIRED) is never pinned.

Stamp and release are in-place edits of ``state.table``'s FLAGS lane on
the state's own device, read and written there: nothing is read back to
the host, so a whole admission batch is a few queued operations, ordered
against the scheduler's dispatches by the stream. A batch is padded to a
fixed width; the JAX package drops the padding lanes by scattering them
to the row past the table, which on a CUDA tensor is a device-side
assert, not a dropped write. Here every lane reads and writes a row
inside the table (padding lanes read row 0), and a lane that must leave
its row unchanged writes that row's own value: the lanes are merged by
``amax`` (a stamp only sets bits, so its value is never below the row's)
and ``amin`` (a release only clears them), so a padding lane never
undoes a live lane's write to the same row, in any order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import FAST, SLOW
from ..core import table as table_lib
from ..core.emulator import EmulatorState
from .staging import to_device


def _merge_flags(table: torch.Tensor, rows: torch.Tensor,
                 vals: torch.Tensor, reduce: str) -> None:
    """Write ``vals`` into the FLAGS lane of ``rows`` (all inside the
    table), lanes aimed at one row merged by ``reduce``."""
    flat = table.view(-1)
    flat.scatter_reduce_(0, rows * table_lib.ROW_W + table_lib.FLAGS,
                         vals.to(table.dtype), reduce=reduce)


def _stamp(table, active, page_a, page_b, pages, live) -> None:
    n_pages = table.shape[0]
    rows = pages.clamp(0, n_pages - 1).to(torch.int64)
    dev = table[rows, table_lib.DEVICE]
    in_swap_a = (active != 0) & (pages == page_a)
    in_swap_b = (active != 0) & (pages == page_b)
    dev = torch.where(in_swap_a, FAST, torch.where(in_swap_b, SLOW, dev))
    bit = torch.where(dev == FAST, table_lib.PIN_FAST, table_lib.PIN_SLOW)
    cur = table[rows, table_lib.FLAGS]
    # Never pin a page whose frame is dying or dead: a pin on a POISONED
    # page would both violate the table invariant and veto its own
    # rescue. The scheduler re-places such contracts on healthy pages.
    healthy = (cur & (table_lib.POISONED | table_lib.RETIRED)) == 0
    bit = torch.where(live & healthy, bit, 0).to(torch.int32)
    _merge_flags(table, rows, cur | bit, "amax")


def _release(table, pages, live) -> None:
    rows = pages.clamp(0, table.shape[0] - 1).to(torch.int64)
    cur = table[rows, table_lib.FLAGS]
    _merge_flags(table, rows,
                 torch.where(live, cur & ~table_lib.PINNED, cur), "amin")


def _pad(pages, width: int | None, device: torch.device):
    """(pages int32[width] on ``device``, live mask): the batch padded
    with page 0 on the host, then copied without waiting; the mask is
    built on the device. Refuses more pages than the width."""
    pages = np.asarray(pages, np.int32).reshape(-1)
    n = pages.shape[0]
    width = n if width is None else width
    if width < n:
        raise ValueError(f"{n} contract pages exceed the pad width {width}")
    padded = np.zeros(width, np.int32)
    padded[:n] = pages
    live = torch.arange(width, device=device) < n
    return to_device(padded, device), live


def stamp_pin_pages(state: EmulatorState, pages, *,
                    width: int | None = None) -> EmulatorState:
    """Stamp pin contracts on ``pages`` (device-accurate, swap-aware,
    health-aware), editing ``state.table`` in place; returns ``state``.

    ``width`` pads the batch to a fixed size (a scheduler admitting a
    variable number of sequences a step uses one); None takes the batch's
    own length. ``pages`` is host data (a sequence or a numpy array)."""
    pages, live = _pad(pages, width, state.table.device)
    _stamp(state.table, state.dma.active, state.dma.page_a,
           state.dma.page_b, pages, live)
    return state


def release_pin_pages(state: EmulatorState, pages, *,
                      width: int | None = None) -> EmulatorState:
    """Clear the pin contracts of ``pages`` (both pin bits — release is
    tier-agnostic), in place. Same padding contract as
    :func:`stamp_pin_pages`."""
    pages, live = _pad(pages, width, state.table.device)
    _release(state.table, pages, live)
    return state
