"""The frozen generator draws the program's traces, request for request."""
import pytest
import torch

from hmes_bench import tracegen

SEEDS = (0, 7, 2 ** 31 + 5, 4 * (2 ** 31 + 5) + 3)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(tracegen.WORKLOADS))
def test_frozen_generator_equals_program(name, seed):
    from repro_torch.trace.generators import generate
    from repro_torch.trace.workloads import workload_spec
    ours = tracegen.generate(tracegen.workload_spec(name, scale=1e-9,
                                                    seed=seed))
    theirs = generate(workload_spec(name, scale=1e-9, seed=seed))
    assert len(ours.page) == 2048
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_recipe_table_equals_program():
    from repro_torch.trace.workloads import WORKLOADS
    assert {k: vars(v) for k, v in tracegen.WORKLOADS.items()} == \
        {k: vars(v) for k, v in WORKLOADS.items()}


@pytest.mark.parametrize("scale,n", [(1e-4, 1342177), (1e-5, 970662)])
def test_cells_request_counts(scale, n):
    name = "520.omnetpp" if scale == 1e-4 else "505.mcf"
    assert tracegen.workload_spec(name, scale=scale).n_requests == n
