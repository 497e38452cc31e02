"""``Engine.sweep`` of the traffic's grid split over the cell's ``chips``
cards (``mesh=`` the first that many CUDA devices; the point axis in
equal contiguous shares, a share a card): ``entries/sweep.py``'s session
otherwise. An answer is one split sweep of a whole trace, every point
from a fresh state, until every point's row (``SweepResult.rows()``) is
on the host, so it holds each share's launch and the gather onto the
engine's card. On the CPU (the benchmark's tests) the mesh is the CPU
that many times, as the program allows."""
from __future__ import annotations

import pathlib

import torch

from hmes_bench import discover

_sweep = discover.entry(pathlib.Path(__file__).resolve().parents[2], "sweep")


def mesh(device: torch.device, cards: int) -> tuple:
    """The devices of the split: cuda:0..cards-1 for a CUDA ``device``,
    which must see that many; ``device`` ``cards`` times otherwise."""
    if device.type != "cuda":
        return (device,) * cards
    if torch.cuda.device_count() < cards:
        raise RuntimeError(f"the cell splits the sweep over {cards} "
                           f"cards; {torch.cuda.device_count()} visible")
    return tuple(torch.device("cuda", i) for i in range(cards))


class Session(_sweep.Session):
    def __init__(self, config: dict, traffic: dict, device, chips: int):
        self.mesh = mesh(torch.device(device), chips)
        super().__init__(config, traffic, self.mesh[0])

    def answer(self, trace):
        """(result, readout): the timed call."""
        res = self.engine.sweep(self.spec, trace, mesh=self.mesh)
        return res, res.rows()


def prepare(config: dict, traffic: dict, device, chips: int) -> Session:
    return Session(config, traffic, device, chips)
