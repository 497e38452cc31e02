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

import torch

from .config import EmulatorConfig, FAST, SLOW

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


def swap_commit_lanes(k: torch.Tensor) -> torch.Tensor:
    """Lane ids of the DMA swap commit's delta pairs, by pair index ``k``:
    (DEVICE, FRAME, EPOCH, WEAR, FLAGS)."""
    lanes = torch.tensor([DEVICE, FRAME, EPOCH, WEAR, FLAGS],
                         dtype=torch.int32, device=k.device)
    return lanes[k.to(torch.int64)]


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

