"""The plain reference against the program on the CPU, where the program
runs its own plain chunk loop: equal, field for field, for a run under
each built-in policy and for a 4-point sweep; and the control (the
counters folded in bfloat16) caught by the comparison."""
import dataclasses

import numpy as np
import pytest
import torch

from hmes_bench import judge, program, reference, tracegen

POLICIES = ("static", "hotness", "write_bias", "stream", "hotness_global",
            "wear_level")
GRID = {"technologies": ["3dxpoint", "stt-ram"],
        "policies": ["hotness", "write_bias"]}


def small_config(**kw) -> dict:
    from repro_torch.core.config import small_platform
    fields = dataclasses.asdict(small_platform(**kw))
    fields["fast"], fields["slow"] = fields["fast"]["name"], \
        fields["slow"]["name"]
    return {"platform": fields}


def hot_trace(n_pages: int, n_fast: int, n: int, seed: int):
    """Random pages with a hot set in the slow tier, so pages migrate."""
    rng = np.random.default_rng(seed)
    page = rng.integers(0, n_pages, n).astype(np.int32)
    hot = rng.random(n) < 0.4
    page[hot] = n_fast + rng.integers(0, 4, hot.sum())
    offset = (rng.integers(0, 64, n) * 64).astype(np.int32)
    return tracegen.Trace(torch.from_numpy(page), torch.from_numpy(offset),
                          torch.from_numpy(rng.random(n) < 0.35),
                          torch.full((n,), 64, dtype=torch.int32))


def program_record(config, grid, trace):
    from repro_torch import Engine
    from repro_torch.sweep import SweepSpec
    cpu = torch.device("cpu")
    cfg = program.platform(config["platform"])
    eng = Engine(cfg, device="cpu")
    t = program.trace_on(trace, cpu)
    n = len(trace.page)
    if grid is None:
        res = eng.run(t)
        return program.record(res.state, res.outs, [res.summary()], n,
                              batched=False)
    res = eng.sweep(SweepSpec(cfg, technologies=tuple(grid["technologies"]),
                              policies=tuple(grid["policies"])), t)
    return program.record(res.states, res.outs, res.rows(), n, batched=True)


@pytest.mark.parametrize("policy", POLICIES)
def test_reference_equals_program_run(policy):
    config = small_config(policy=policy, decay_every=4,
                          endurance_budget=30)
    trace = hot_trace(64, 8, 1000, seed=POLICIES.index(policy))
    want = reference.answer(config, None, trace, torch.device("cpu"))
    got = program_record(config, None, trace)
    assert judge.compare(got, want) == dict.fromkeys(judge.LIMITS, 0)
    assert int(want["state"]["dma.swaps_done"].sum()) > 0 or \
        policy == "static"


def test_reference_equals_program_sweep():
    config = small_config(write_weight=4)
    trace = hot_trace(64, 8, 1000, seed=11)
    want = reference.answer(config, GRID, trace, torch.device("cpu"))
    got = program_record(config, GRID, trace)
    assert len(want["readout"]) == 4
    assert [r["label"] for r in got["readout"]] == \
        [r["label"] for r in want["readout"]]
    assert judge.compare(got, want) == dict.fromkeys(judge.LIMITS, 0)


@pytest.mark.parametrize("grid", [None, GRID])
def test_control_fails_the_comparison(grid):
    config = small_config()
    trace = hot_trace(64, 8, 1000, seed=3)
    want, low = reference.answer(config, grid, trace, torch.device("cpu"),
                                 control=True)
    numbers = judge.compare(low, want)
    assert numbers["outs_differ"] == numbers["state_differ"] == 0
    assert numbers["counters_differ"] > 0 and not judge.verdict(numbers)


def test_judge_counts_each_kind_of_difference():
    config = small_config()
    trace = hot_trace(64, 8, 200, seed=5)
    want = reference.answer(config, None, trace, torch.device("cpu"))
    got = {"outs": {k: v.clone() for k, v in want["outs"].items()},
           "state": {k: v.clone() for k, v in want["state"].items()},
           "readout": [dict(want["readout"][0])]}
    got["outs"]["latency"][0, 3] += 1
    got["state"]["table"][0, 5, 2] += 1
    got["state"]["counters.energy_pj"] = torch.nextafter(
        got["state"]["counters.energy_pj"], torch.tensor(float("inf")))
    got["readout"][0]["reads_fast"] += 1
    del got["outs"]["device"]
    n = want["outs"]["device"].numel()
    assert judge.compare(got, want) == {
        "outs_differ": 1 + n, "state_differ": 1, "counters_differ": 1,
        "answer_differ": 1}
