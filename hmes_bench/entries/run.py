"""``Engine.run`` of the configuration's design point: an answer is one
run of a whole trace from a fresh state, until its counter summary
(``RunResult.summary()``) is on the host."""
from __future__ import annotations

from hmes_bench import program


class Session:
    def __init__(self, config: dict, device):
        from repro_torch import Engine
        self.engine = Engine(program.platform(config["platform"]),
                             device=device)
        self.points = 1
        self.grid = None

    def answer(self, trace):
        """(result, readout): the timed call."""
        res = self.engine.run(trace)
        return res, [res.summary()]

    def record(self, result, readout, n: int) -> dict:
        return program.record(result.state, result.outs, readout, n,
                              batched=False)

    def device_out(self, result, n: int):
        """[1, n]: the device each request went to."""
        return result.outs["device"][None, :n]

    def point_geometry(self) -> list[dict]:
        c = self.engine.cfg
        return [{"n_pages": c.n_pages, "n_slow_pages": c.n_slow_pages,
                 "decay_every": c.decay_every}]


def prepare(config: dict, traffic: dict, device, chips: int) -> Session:
    program.one_card("run", chips)
    return Session(config, device)
