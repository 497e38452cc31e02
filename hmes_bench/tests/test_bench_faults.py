"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU with one fault planted in the program; in the split sweep
(``entries/sweep_mesh.py``) also the exchange between cards left out."""
import time

import pytest
import torch

from hmes_bench import harness


def _unchanged_state(real):
    """A chunk step that returns the state it was given."""
    def step(cfg, registry, table, params, sc, bank_free, *args, **kw):
        _, _, _, outs = real(cfg, registry, table.clone(), params, sc,
                             bank_free, *args, **kw)
        return table, sc, bank_free, outs
    return step


def _half_batch(real):
    """Half of each chunk's requests left out of the step."""
    def step(cfg, registry, table, params, sc, bank_free, page, offset,
             is_write, size, valid, *args, **kw):
        valid = valid.clone()
        valid[..., valid.shape[-1] // 2:] = False
        return real(cfg, registry, table, params, sc, bank_free, page,
                    offset, is_write, size, valid, *args, **kw)
    return step


def _altered_answer(real):
    """One request's latency altered where the step produces it."""
    def step(*args, **kw):
        table, sc, bank_free, outs = real(*args, **kw)
        outs = dict(outs, latency=outs["latency"].clone())
        outs["latency"][..., 0] += 1
        return table, sc, bank_free, outs
    return step


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("cell", ["tiny.run", "tiny.sweep4", "tiny.sweep8x4"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(scratch_root, monkeypatch, cell,
                                      fault):
    from repro_torch.kernels import chunk_step
    monkeypatch.setattr(chunk_step, "step_batch",
                        FAULTS[fault](chunk_step.step_batch))
    r = harness.run_cell(scratch_root, cell, 9, 0.2, False,
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_half_of_the_points_left_out_is_not_correct(scratch_root,
                                                    monkeypatch):
    """The sweep's points: the second half left out, each given the
    result of a point of the first half."""
    from repro_torch import engine
    real = engine._emulate_batch_impl

    def half(cfg, registry, trace, valid, states, params, *a, **kw):
        b = states.table.shape[0]
        keep = lambda t: torch.cat([t[:b // 2]] * 2)[:b]
        st = engine._map_state(keep, states)
        new, outs = real(cfg, registry, trace, valid, st,
                         engine._map_state(keep, params), *a, **kw)
        return new, outs
    monkeypatch.setattr(engine, "_emulate_batch_impl", half)
    r = harness.run_cell(scratch_root, "tiny.sweep4", 9, 0.2, False,
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"] is False


def test_exchange_left_out_is_not_correct(scratch_root, monkeypatch):
    """The split sweep's gather: no share of another card brought home,
    the engine's own card's share in each one's place."""
    from repro_torch.engine import Engine
    real = Engine._gather

    def gather(self, shares, n):
        return real(self, [shares[0]] * len(shares), n)
    monkeypatch.setattr(Engine, "_gather", gather)
    r = harness.run_cell(scratch_root, "tiny.sweep8x4", 9, 0.2, False,
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"] is False
    assert r["checks"]["outs_differ"]["value"] > 0
