"""The benchmark's own tests, run on the CPU (the card's marked ``cuda``):

    python3 -m pytest -q hmes_bench/tests

``scratch_root`` is a copy of the benchmark in a temporary checkout with
three small cells added by data files alone: ``tiny.run``, ``tiny.sweep4``
and ``tiny.sweep8x4`` (520.omnetpp's recipe at 2,048 requests on a
65,536-page platform, chunk 128; a 4-point grid; an 8-point grid split
over 4 cards, which on the CPU are the CPU 4 times)."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY_PLATFORM = dict(n_fast_pages=8192, n_slow_pages=57344, chunk=128)
TINY_GRID = {"technologies": ["3dxpoint", "stt-ram"],
             "policies": ["hotness", "static"]}
TINY_MESH_GRID = dict(TINY_GRID, link_lats=[600, 1200])


def add_cell(root: pathlib.Path, cell: dict) -> None:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def make_scratch(root: pathlib.Path) -> pathlib.Path:
    """A checkout holding BENCHMARK.json and hmes_bench/, plus the tiny
    configuration, its traffic and its three cells."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "hmes_bench", root / "hmes_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    own = root / "hmes_bench"
    cfg = json.loads((own / "configs" / "table2-omnetpp.json").read_text())
    cfg["name"] = "tiny"
    cfg["platform"].update(TINY_PLATFORM)
    cfg["trace"]["scale"] = 1e-9
    cfg["requests"] = 2048
    (own / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((own / "traffic" / "sweep16.json").read_text())
    traffic["grid"] = TINY_GRID
    (own / "traffic" / "sweep4.json").write_text(json.dumps(traffic))
    traffic = json.loads((own / "traffic" / "sweep16x4.json").read_text())
    traffic["grid"] = TINY_MESH_GRID
    (own / "traffic" / "sweep8x4.json").write_text(json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test's platform",
                             "file": "hmes_bench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    for name, traffic, chips in (("tiny.run", "run", 1),
                                 ("tiny.sweep4", "sweep4", 1),
                                 ("tiny.sweep8x4", "sweep8x4", 4)):
        add_cell(root, {"name": name, "config": "tiny", "traffic": traffic,
                        "chips": chips, "why": "a test"})
    return root


@pytest.fixture(scope="session")
def scratch_root(tmp_path_factory) -> pathlib.Path:
    return make_scratch(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def fresh_root(tmp_path) -> pathlib.Path:
    """A scratch checkout of the test's own, free to change."""
    return make_scratch(tmp_path / "checkout")
