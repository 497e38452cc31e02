"""The split sweep's entry, ``entries/sweep_mesh.py``: the 16-point grid
of ``traffic/sweep16x4.json`` goes to the program as four shares of 4
points, one on each of the cell's four cards, a machine with fewer cards
than the cell asks for is refused, and the one-card entries refuse a
cell of several."""
import json
import pathlib

import pytest
import torch

from hmes_bench import discover, harness, program

ROOT = pathlib.Path(__file__).resolve().parents[2]


def test_16_points_split_4_a_card(scratch_root, monkeypatch):
    from repro_torch import engine
    shares = []
    real = engine._emulate_batch_impl

    def spy(cfg, registry, trace, valid, states, params, *a, **kw):
        shares.append((len(params.policy_id), valid.device))
        return real(cfg, registry, trace, valid, states, params, *a, **kw)
    monkeypatch.setattr(engine, "_emulate_batch_impl", spy)
    bench = discover.load_benchmark(ROOT)
    cell = discover.cell(bench, "table2-mcf.sweep16x4")
    config = discover.config(scratch_root,
                             discover.load_benchmark(scratch_root), "tiny")
    traffic = discover.traffic(ROOT, cell["traffic"])
    assert "cards" not in traffic and cell["chips"] == 4
    cpu = torch.device("cpu")
    session = discover.entry(ROOT, traffic["entry"]).prepare(
        config, traffic, cpu, cell["chips"])
    assert session.points == 16 and session.mesh == (cpu,) * 4
    trace = harness.make_traces(config, traffic, 3, count=1)[0]
    trace = type(trace)(*(x[:256] for x in trace))
    res, rows = session.answer(program.trace_on(trace, cpu))
    assert shares == [(4, cpu)] * 4
    assert len(rows) == 16 and res.outs["device"].shape[0] == 16
    # The grid is the one-card sweep cell's, and every fast tier of it lies
    # under 505.mcf's footprint.
    assert traffic["grid"] == discover.traffic(ROOT, "sweep16")["grid"]
    mcf = json.loads((ROOT / "hmes_bench/configs/table2-mcf.json").read_text())
    n = mcf["platform"]["n_fast_pages"] + mcf["platform"]["n_slow_pages"]
    fast = [round(n * f) for f in traffic["grid"]["fast_fractions"]]
    assert fast == [32768, 65536]
    assert max(fast) < mcf["footprint_pages"]


def test_fewer_cards_are_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = discover.entry(ROOT, "sweep_mesh").mesh
    with pytest.raises(RuntimeError, match="4 cards; 3 visible"):
        mesh(torch.device("cuda", 0), 4)
    assert mesh(torch.device("cuda", 0), 3) == tuple(
        torch.device("cuda", i) for i in range(3))


@pytest.mark.parametrize("entry", ["run", "sweep"])
def test_one_card_entries_refuse_several(scratch_root, entry):
    config = discover.config(scratch_root,
                             discover.load_benchmark(scratch_root), "tiny")
    traffic = discover.traffic(ROOT, "sweep16")
    with pytest.raises(ValueError, match="runs on one card; the cell asks "
                                         "for 4"):
        discover.entry(ROOT, entry).prepare(config, traffic,
                                            torch.device("cpu"), 4)
