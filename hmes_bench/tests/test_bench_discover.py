"""A later cell, configuration, traffic mix and metric are new files and
new entries: the harness finds them by name and runs them, with no file
that is there edited."""
import json
import time

import pytest
import torch

from hmes_bench import discover, harness
from hmes_bench.tests.conftest import add_cell

READER = '''"""Answers per second of the window."""


def read(ctx):
    return len(ctx.answers_ms) / ctx.window_s
'''


def test_added_files_make_a_new_cell(fresh_root):
    before = {p: p.read_bytes() for p in (fresh_root / "hmes_bench").rglob(
        "*") if p.is_file()}
    own = fresh_root / "hmes_bench"
    cfg = json.loads((own / "configs" / "tiny.json").read_text())
    cfg["name"] = "tiny-leela"
    cfg["trace"] = {"workload": "541.leela", "scale": 1e-9}
    (own / "configs" / "tiny-leela.json").write_text(json.dumps(cfg))
    (own / "traffic" / "grid2.json").write_text(json.dumps(
        {"entry": "sweep", "traces": 2, "clients": 1, "loop": "closed",
         "grid": {"link_lats": [600, 2400]}}))
    (own / "metrics" / "answers_per_s.py").write_text(READER)
    bench = json.loads((fresh_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-leela", "source": "a test",
                             "file": "hmes_bench/configs/tiny-leela.json",
                             "reduced": [], "why": "a test"})
    bench["end_to_end"].append({"name": "answers_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny-leela.grid2"]})
    (fresh_root / "BENCHMARK.json").write_text(json.dumps(bench))
    add_cell(fresh_root, {"name": "tiny-leela.grid2", "config": "tiny-leela",
                          "traffic": "grid2", "chips": 1, "why": "a test"})

    names = [m["name"] for m in discover.cell_metrics(
        discover.load_benchmark(fresh_root), "tiny-leela.grid2", False)]
    assert names == ["emulated_req_per_s", "answer_ms.p95", "setup_s",
                     "answers_per_s"]
    r = harness.run_cell(fresh_root, "tiny-leela.grid2", 3, 0.01, False,
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"] and set(r["metrics"]) == set(names)
    assert r["metrics"]["answers_per_s"]["unit"] == "1/s"
    # The new metric is the new cell's alone.
    assert "answers_per_s" not in [m["name"] for m in discover.cell_metrics(
        discover.load_benchmark(fresh_root), "tiny.run", False)]
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_unknown_names_are_refused(scratch_root):
    bench = discover.load_benchmark(scratch_root)
    with pytest.raises(KeyError):
        discover.cell(bench, "no-such-cell")
    with pytest.raises(KeyError):
        discover.config(scratch_root, bench, "no-such-config")
    with pytest.raises(FileNotFoundError):
        discover.reader(scratch_root, "no_such_metric")


@pytest.mark.parametrize("cell", ["tiny.run", "tiny.sweep4", "tiny.sweep8x4"])
@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(scratch_root, cell, traced):
    # A window shorter than one answer still holds the harness's least
    # number of answers, however slow the host.
    r = harness.run_cell(scratch_root, cell, 2 ** 33 + 1, 0.01, traced,
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"] and r["failed"] == 0
    assert r["attempted"] == harness.MIN_ANSWERS
    assert list(r)[-1] == "checks"
    assert all(c == {"value": 0, "limit": 0} for c in r["checks"].values())
    if not traced:
        assert set(r["metrics"]) == {"emulated_req_per_s", "answer_ms.p95",
                                     "setup_s"}
    else:       # no device trace on the CPU: nothing read, nothing made up
        assert r["metrics"] == {} and r["device"]["busy_s"] is None
