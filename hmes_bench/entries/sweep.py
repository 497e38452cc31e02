"""``Engine.sweep`` of the traffic's grid over the configuration's
platform, on the engine's device alone (``mesh=None``): an answer is one
sweep of a whole trace, every point from a fresh state, until every
point's row (``SweepResult.rows()``) is on the host."""
from __future__ import annotations

from hmes_bench import program


class Session:
    def __init__(self, config: dict, traffic: dict, device):
        from repro_torch import Engine
        from repro_torch.sweep import SweepSpec, build_points
        base = program.platform(config["platform"])
        g = traffic["grid"]
        self.grid = g
        self.spec = SweepSpec(
            base, technologies=tuple(g.get("technologies", ())),
            fast_fractions=tuple(g.get("fast_fractions", ())),
            policies=tuple(g.get("policies", ())),
            link_lats=tuple(g.get("link_lats", ())))
        self.engine = Engine(base, device=device)
        self.cfgs = [p.cfg for p in build_points(self.spec)]
        self.points = len(self.cfgs)

    def answer(self, trace):
        """(result, readout): the timed call."""
        res = self.engine.sweep(self.spec, trace, mesh=None)
        return res, res.rows()

    def record(self, result, readout, n: int) -> dict:
        return program.record(result.states, result.outs, readout, n,
                              batched=True)

    def device_out(self, result, n: int):
        """[B, n]: the device each request went to, a point."""
        return result.outs["device"][:, :n]

    def point_geometry(self) -> list[dict]:
        return [{"n_pages": c.n_pages, "n_slow_pages": c.n_slow_pages,
                 "decay_every": c.decay_every} for c in self.cfgs]


def prepare(config: dict, traffic: dict, device, chips: int) -> Session:
    program.one_card("sweep", chips)
    return Session(config, traffic, device)
