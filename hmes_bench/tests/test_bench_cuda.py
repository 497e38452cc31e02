"""On the card: the tiny cells through the kernel route, correct, with
every per-layer metric read from the device trace."""
import time

import pytest
import torch

from hmes_bench import discover, harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.run", "tiny.sweep4"])
def test_tiny_cells_on_the_card(scratch_root, card, cell):
    r = harness.run_cell(scratch_root, cell, 2 ** 31 + 7, 1.0, True, card,
                         time.perf_counter())
    assert r["correct"], r["checks"]
    per = {m["name"] for m in discover.cell_metrics(
        discover.load_benchmark(scratch_root), cell, True)}
    assert set(r["metrics"]) == per
    assert 0 < r["metrics"]["chunk_step_roofline"]["value"] <= 100
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
