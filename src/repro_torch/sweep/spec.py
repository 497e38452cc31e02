"""Design-space sweep specification (PyTorch port of ``repro.sweep.spec``).

A sweep is a cartesian grid over *runtime* design axes (NVM technology,
fast-tier share, placement policy, link latency, and any
``RuntimeParams``-backed ``EmulatorConfig`` field) expanded into a list
of :class:`DesignPoint`. Every point must agree on the static geometry
(``config.static_key``): that is what lets ``repro_torch.Engine.sweep``
stack the per-point ``RuntimeParams`` along a leading point axis and run
the whole grid as one launch of the chunk-step kernel. Axis order,
coordinate rounding and the geometry check are the JAX package's.
"""
from __future__ import annotations

import dataclasses
import itertools

from ..core.config import (TECHNOLOGIES, EmulatorConfig, RuntimeParams,
                           static_key)

# EmulatorConfig fields that map 1:1 onto RuntimeParams and are therefore
# sweepable through ``extra_axes``.
RUNTIME_FIELDS = frozenset({
    "link_lat", "link_bytes_per_cycle", "issue_gap", "dma_bytes_per_cycle",
    "hot_threshold", "hotness_decay_shift", "decay_every", "write_weight",
    "wear_slack", "pin_fast_fraction", "endurance_budget",
    "power_pj_per_bit_fast", "power_pj_per_bit_slow_read",
    "power_pj_per_bit_slow_write",
})


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One evaluated configuration: its coordinates on the sweep axes and
    the fully resolved ``EmulatorConfig``."""

    index: int
    coords: tuple[tuple[str, object], ...]
    cfg: EmulatorConfig

    @property
    def label(self) -> str:
        return "/".join(f"{k}={v}" for k, v in self.coords)

    def params(self, device=None) -> RuntimeParams:
        """The point's runtime parameters on ``device`` (``policy_id``
        indexes the built-in policies)."""
        return RuntimeParams.from_config(self.cfg, device=device)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Cartesian sweep recipe over the platform's runtime design axes.

    ``technologies`` names entries of ``TECHNOLOGIES`` for the slow tier;
    ``fast_fractions`` are fast-tier shares of the (static) total page
    space; ``policies`` are registered policy names; ``link_lats`` are link
    round-trip cycle counts. ``extra_axes`` sweeps any field in
    ``RUNTIME_FIELDS``, e.g. ``(("hot_threshold", (2, 8)),)``. Axes left
    empty stay at the ``base`` value.
    """

    base: EmulatorConfig
    technologies: tuple[str, ...] = ()
    fast_fractions: tuple[float, ...] = ()
    policies: tuple[str, ...] = ()
    link_lats: tuple[int, ...] = ()
    extra_axes: tuple[tuple[str, tuple], ...] = ()

    def build(self) -> list[DesignPoint]:
        """Expand the grid (:func:`build_points` as a method)."""
        return build_points(self)


def _with_fast_fraction(cfg: EmulatorConfig, frac: float) -> EmulatorConfig:
    n = cfg.n_pages
    nf = min(max(int(round(n * frac)), 1), n - 1)
    return cfg.with_(n_fast_pages=nf, n_slow_pages=n - nf)


def _set_field(field: str, value):
    return lambda c: c.with_(**{field: value})


def _axes(spec: SweepSpec) -> list[tuple[str, list]]:
    """Each axis is (name, [(coordinate value, cfg transform), ...])."""
    axes = []
    if spec.technologies:
        axes.append(("tech", [(t, _set_field("slow", TECHNOLOGIES[t]))
                              for t in spec.technologies]))
    if spec.fast_fractions:
        axes.append(("fast_frac", [
            (round(f, 4), lambda c, f=f: _with_fast_fraction(c, f))
            for f in spec.fast_fractions]))
    if spec.policies:
        axes.append(("policy", [(p, _set_field("policy", p))
                                for p in spec.policies]))
    if spec.link_lats:
        axes.append(("link_lat", [(v, _set_field("link_lat", v))
                                  for v in spec.link_lats]))
    for field, values in spec.extra_axes:
        if field not in RUNTIME_FIELDS:
            raise ValueError(
                f"{field!r} is not a runtime-sweepable field; choose from "
                f"{sorted(RUNTIME_FIELDS)} (static geometry changes need a "
                "sweep of their own)")
        axes.append((field, [(v, _set_field(field, v)) for v in values]))
    return axes


def build_points(spec: SweepSpec) -> list[DesignPoint]:
    """Expand the cartesian grid; validates static-geometry agreement."""
    axes = _axes(spec)
    base_key = static_key(spec.base)
    names = [name for name, _ in axes]
    points = []
    for i, combo in enumerate(itertools.product(*(v for _, v in axes))):
        cfg = spec.base
        for value, transform in combo:
            cfg = transform(cfg)
        coords = tuple(zip(names, (value for value, _ in combo)))
        if static_key(cfg) != base_key:
            raise ValueError(f"design point {list(coords)} changed static "
                             f"geometry ({static_key(cfg)} != {base_key})")
        points.append(DesignPoint(index=i, coords=coords, cfg=cfg))
    return points
