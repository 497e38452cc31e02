"""Find a cell's pieces by the names that ``BENCHMARK.json`` gives them.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the one its ``configs`` entry names; the
traffic mix is ``traffic/<name>.json``; the traffic names an entry point,
``entries/<name>.py``; each metric is read by ``metrics/<name>.py``. A
later cell, configuration, traffic mix or metric is a new file and a new
entry, never an edit of a file that is here.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from types import ModuleType

HERE = pathlib.Path(__file__).resolve().parent


def load_benchmark(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(root: pathlib.Path, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(root: pathlib.Path, name: str) -> dict:
    return json.loads((_own(root) / "traffic" / f"{name}.json").read_text())


def _own(root: pathlib.Path) -> pathlib.Path:
    """This package's directory inside the checkout at ``root``."""
    return root / HERE.name


def _module(path: pathlib.Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    tag = re.sub(r"\W", "_", f"{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(f"hmes_bench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(root: pathlib.Path, name: str) -> ModuleType:
    """The entry point ``entries/<name>.py``: ``prepare(config, traffic,
    device, chips)`` returns the session the window drives on the cell's
    ``chips`` cards, or refuses a number of cards it does not use."""
    return _module(_own(root) / "entries" / f"{name}.py")


def reader(root: pathlib.Path, name: str) -> ModuleType:
    """The reader of metric ``name``, ``metrics/<name>.py``: ``read(ctx)``
    returns the metric's value, or None where the run gives it nothing to
    read."""
    return _module(_own(root) / "metrics" / f"{name}.py")


def cell_metrics(bench: dict, name: str, traced: bool) -> list[dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced (a metric with a
    ``workloads`` list only in the cells it lists)."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", (name,))]
