"""The design points a cell asks for, worked out from its configuration
and its traffic's grid: each point's platform, its label, and the
points' runtime parameters stacked along a leading point axis (the grid
expanded in the order technology, fast-tier share, policy, link
latency)."""
from __future__ import annotations

import itertools

import torch

from .config import TECHNOLOGIES, EmulatorConfig, RuntimeParams
from .policies import PolicyRegistry


def platform(fields: dict) -> EmulatorConfig:
    """An ``EmulatorConfig`` from a configuration file's ``platform``
    (technologies by name)."""
    kw = dict(fields)
    kw["fast"] = TECHNOLOGIES[kw["fast"]]
    kw["slow"] = TECHNOLOGIES[kw["slow"]]
    return EmulatorConfig(**kw)


def _with_fast_fraction(cfg: EmulatorConfig, frac: float) -> EmulatorConfig:
    n = cfg.n_pages
    nf = min(max(int(round(n * frac)), 1), n - 1)
    return cfg.with_(n_fast_pages=nf, n_slow_pages=n - nf)


def expand(base: EmulatorConfig, grid: dict | None
           ) -> list[tuple[tuple, EmulatorConfig]]:
    """[(coords, cfg)] of every point: the base alone without a grid,
    else the cartesian grid over the axes ``grid`` names."""
    if not grid:
        return [((), base)]
    axes = []
    if grid.get("technologies"):
        axes.append(("tech", [(t, lambda c, t=t: c.with_(
            slow=TECHNOLOGIES[t])) for t in grid["technologies"]]))
    if grid.get("fast_fractions"):
        axes.append(("fast_frac", [(round(f, 4), lambda c, f=f:
                                    _with_fast_fraction(c, f))
                                   for f in grid["fast_fractions"]]))
    if grid.get("policies"):
        axes.append(("policy", [(p, lambda c, p=p: c.with_(policy=p))
                                for p in grid["policies"]]))
    if grid.get("link_lats"):
        axes.append(("link_lat", [(v, lambda c, v=v: c.with_(link_lat=v))
                                  for v in grid["link_lats"]]))
    names = [name for name, _ in axes]
    out = []
    for combo in itertools.product(*(v for _, v in axes)):
        cfg = base
        for _, transform in combo:
            cfg = transform(cfg)
        out.append((tuple(zip(names, (v for v, _ in combo))), cfg))
    return out


def stacked(points: list[tuple[tuple, EmulatorConfig]], device
            ) -> tuple[PolicyRegistry, RuntimeParams]:
    """The registry of the policies present (in order of first
    appearance) and every point's runtime parameters, 1-D tensors of
    length B, ``policy_id`` indexing that registry."""
    names: list[str] = []
    for _, cfg in points:
        if cfg.policy not in names:
            names.append(cfg.policy)
    registry = PolicyRegistry.snapshot(names)
    per = [RuntimeParams.from_config(cfg, policy_id=registry.index(
        cfg.policy)) for _, cfg in points]
    return registry, RuntimeParams(*(torch.stack(xs).to(device)
                                     for xs in zip(*per)))
