"""AdamW over trees of tensors (the port of ``repro.optim.adamw``).

Moments are float32 whatever the parameter's dtype. ``adamw_update``
writes the parameters and the moments IN PLACE, a block of elements at a
time, so a full-width model needs no second copy of either (the returned
trees hold the same tensors).

The arithmetic is the reference's as XLA compiles it under ``jit`` on
the CPU, op for op, so the port agrees with it bit for bit and gives the
same bits on the CPU and on a card:

- XLA's simplifier folds ``(mu / b1c) / (sqrt(nu / b2c) + eps)`` into
  ``mu / (b1c * (sqrt(nu / b2c) + eps))``, and the code generator fuses
  ``b1 * mu + (1 - b1) * g`` into ``fma(mu, b1, (1 - b1) * g)`` (the same
  for ``nu`` over ``(g * g) * (1 - b2)``), ``q + wd * p`` into
  ``fma(p, wd, q)`` and ``p - lr * delta`` into ``fma(-lr, delta, p)``.
  Those fused multiply-adds are rounded once here too
  (``core.counters.fma``, exact on every device).
- The schedule's scalars (``warmup_cosine``, the bias corrections) are
  computed on the host in float32 in XLA's order (a division by a
  constant becomes a product by its float32 reciprocal); its ``cos`` and
  ``pow`` are rounded from float64, where XLA's own float32 versions can
  be one ulp away.
- The global norm squares in float32, as the reference does, and sums in
  float64: no float32 summation order is shared by XLA, the CPU and a
  card, and the float64 sum rounds to the same float32 on all of them.

On a mesh (ZeRO-1, the reference's moment specs ``zero1_specs``) each
rank holds its block of the moments and of the gradients, and its block
of the parameters under their own specs, which the ZeRO-1 specs may
split once more over ``"data"``. The rank then updates that contiguous
sub-block of its parameters with the same per-element arithmetic and
all-gathers it over ``"data"`` back into its block, so that the step
equals the whole-leaf step bit for bit. The global norm sums each rank's
float64 partials over the axes that split its blocks only: a block is
the same on every rank of the axes it is replicated on, and counts once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import dist
from ..core.counters import fma
from ..models.sharding import local_slice, spec_axes, entry_axes
from ..tree import leaves, tree_map

# Elements a block of the in-place update: its float64 temporaries stay
# at 128 MiB each.
BLOCK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    mu: dict
    nu: dict
    step: torch.Tensor          # int32, 0-dim


def init_opt_state(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def _f32(x) -> np.float32:
    return np.float32(x)


def _lr(cfg: AdamWConfig, step: int) -> np.float32:
    s = _f32(step)
    warm = s * (_f32(1) / _f32(max(1, cfg.warmup_steps)))
    prog = (s + _f32(-cfg.warmup_steps)) * (
        _f32(1) / _f32(max(1, cfg.total_steps - cfg.warmup_steps)))
    prog = min(_f32(1), max(_f32(0), prog))
    cos = _f32(math.cos(float(prog * _f32(math.pi))))
    cos = (cos + _f32(1)) * _f32(0.5)
    return (warm if s < _f32(cfg.warmup_steps) else cos) * _f32(cfg.lr_peak)


def warmup_cosine(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-dim tensor), a float32
    0-dim tensor on the CPU."""
    return torch.tensor(_lr(cfg, int(step)), dtype=torch.float32)


def _bias_correction(b: float, step: int) -> np.float32:
    """``1 - b ** step`` in float32, the power rounded from float64."""
    return _f32(1) - _f32(float(_f32(b)) ** step)


def _square_sum(g) -> torch.Tensor:
    return torch.sum(torch.square(g.float()), dtype=torch.float64)


def global_norm(grads, sh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of every element's float32 square, a float32 0-dim
    tensor on the gradients' device (the squares summed in float64). On
    ``sh``'s mesh each gradient is this rank's block under ``specs``:
    the blocks' partial sums are grouped by the axes that split them and
    each group is summed over those axes."""
    if sh is None or sh.mesh is None:
        total = sum(_square_sum(g) for g in leaves(grads))
        return torch.sqrt(total.float())
    groups: dict = {}
    for g, spec in zip(leaves(grads), leaves(specs)):
        axes = tuple(a for a in sh.names if a in spec_axes(spec))
        part = _square_sum(g)
        groups[axes] = part if axes not in groups else groups[axes] + part
    total = sum(dist.sum_f64(groups[axes], sh, axes)
                for axes in sorted(groups))
    return torch.sqrt(total.float())


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    top = torch.full((), max_norm, dtype=torch.float32, device=gn.device)
    return torch.clamp(top / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, each in its
    own dtype, the norm before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _scalars(cfg: AdamWConfig, step: int, device) -> dict:
    """The update's float32 constants as 0-dim tensors on ``device`` (a
    tensor divisor keeps CUDA's division exact: a CPU scalar divisor
    would be turned into a product by its reciprocal)."""
    vals = {"b1": cfg.b1, "c1": 1 - cfg.b1, "b2": cfg.b2, "c2": 1 - cfg.b2,
            "b1c": _bias_correction(cfg.b1, step),
            "b2c": _bias_correction(cfg.b2, step), "eps": cfg.eps,
            "wd": cfg.weight_decay, "neg_lr": -_lr(cfg, step)}
    return {k: torch.tensor(_f32(v), dtype=torch.float32, device=device)
            for k, v in vals.items()}


@torch.no_grad()
def _update_leaf(p, g, mu, nu, scale, c: dict) -> None:
    """One leaf's AdamW step in place, BLOCK elements at a time."""
    pf, gf, mf, nf = (t.view(-1) for t in (p, g.contiguous(), mu, nu))
    for lo in range(0, pf.numel(), BLOCK):
        sl = slice(lo, lo + BLOCK)
        gc = (gf[sl].float() * scale).to(g.dtype).float()
        m = fma(mf[sl], c["b1"], gc * c["c1"])
        v = fma(nf[sl], c["b2"], (gc * gc) * c["c2"])
        q = m / (c["b1c"] * (torch.sqrt(v / c["b2c"]) + c["eps"]))
        p32 = pf[sl].float()
        pf[sl] = fma(c["neg_lr"], fma(p32, c["wd"], q), p32).to(p.dtype)
        mf[sl] = m
        nf[sl] = v


def _added_axis(param_spec, moment_spec, sh):
    """The dimension and axis that the moment's spec splits and the
    parameter's does not (ZeRO-1 adds one), or None."""
    added = [(d, a) for d, e in enumerate(moment_spec)
             for a in entry_axes(e)
             if a not in spec_axes(param_spec) and sh.size(a) > 1]
    if len(added) > 1:
        raise ValueError(f"moment spec {moment_spec} splits more than one "
                         f"axis past its parameter's {param_spec}")
    return added[0] if added else None


@torch.no_grad()
def _update_block(p, g, mu, nu, scale, c: dict, param_spec, moment_spec,
                  sh) -> None:
    """One leaf's step on a mesh: ``p`` is the rank's block under
    ``param_spec``; ``g``, ``mu`` and ``nu`` its blocks under
    ``moment_spec``."""
    added = _added_axis(param_spec, moment_spec, sh)
    if added is None:
        _update_leaf(p, g, mu, nu, scale, c)
        return
    d, axis = added
    part_spec = (None,) * d + (axis,)
    part = local_slice(p, part_spec, sh).clone(
        memory_format=torch.contiguous_format)
    _update_leaf(part, g, mu, nu, scale, c)
    p.copy_(dist.all_gather(part, d, sh, axis))


def adamw_update(cfg: AdamWConfig, params, grads, state: OptState, sh=None,
                 param_specs=None, moment_specs=None):
    """One AdamW step: parameters and moments updated IN PLACE. Returns
    (params, new_state, metrics {"lr", "grad_norm"}), the same tensors.
    On ``sh``'s mesh: ``params`` are the rank's blocks under
    ``param_specs``, ``grads`` and the moments its blocks under
    ``moment_specs`` (ZeRO-1)."""
    mesh = sh is not None and sh.mesh is not None
    gn = global_norm(grads, sh, moment_specs) if mesh else global_norm(grads)
    scale = _clip_scale(gn, cfg.clip_norm)
    step = int(state.step) + 1
    c = _scalars(cfg, step, gn.device)
    if mesh:
        tree_map(lambda p, g, mu, nu, ps, ms: _update_block(
            p, g, mu, nu, scale, c, ps, ms, sh), params, grads, state.mu,
            state.nu, param_specs, moment_specs)
    else:
        tree_map(lambda p, g, mu, nu: _update_leaf(p, g, mu, nu, scale, c),
                 params, grads, state.mu, state.nu)
    new_step = torch.full_like(state.step, step)
    return params, OptState(state.mu, state.nu, new_step), \
        {"lr": -c["neg_lr"], "grad_norm": gn}
