"""What a run loads: no JAX and not the JAX package (``repro``), with
names compared whole (``repro_torch`` starts with ``repro``); the plain
reference loads nothing of the program. And the command line without a
card, or without the program, exits non-zero with no result."""
import ast
import json
import pathlib
import subprocess
import sys

import torch

from hmes_bench.harness import FORBIDDEN

ROOT = pathlib.Path(__file__).resolve().parents[2]
REF = ROOT / "hmes_bench" / "reference"


def top_level_modules(code: str) -> set[str]:
    """The top-level names of ``sys.modules`` after ``code`` ran in a
    fresh interpreter at the checkout's root."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
             "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_neither_jax_nor_the_jax_package(scratch_root):
    names = top_level_modules(
        "import pathlib, time, torch\nfrom hmes_bench import harness\n"
        f"for w in ('tiny.run', 'tiny.sweep4'):\n"
        f"    r = harness.run_cell(pathlib.Path({str(scratch_root)!r}), w, 5,"
        " 0.2, True, torch.device('cpu'), time.perf_counter())\n"
        "    assert r['correct'], r\n")
    assert "repro_torch" in names and "hmes_bench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = top_level_modules(
        "import torch\nfrom hmes_bench import reference, tracegen\n"
        "t = tracegen.generate(tracegen.workload_spec('541.leela', 1e-9))\n"
        "import json, pathlib\n"
        "cfg = json.loads(pathlib.Path('hmes_bench/configs/"
        "table2-omnetpp.json').read_text())\n"
        "cfg['platform'].update(n_fast_pages=64, n_slow_pages=5568, "
        "chunk=128)\n"
        "reference.answer(cfg, None, t, torch.device('cpu'))\n")
    assert not names & (FORBIDDEN | {"repro_torch"}), names


def test_reference_sources_import_no_program():
    allowed = {"__future__", "dataclasses", "functools", "inspect",
               "itertools", "typing", "numpy", "torch"}
    for path in REF.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)


def _cli(root: pathlib.Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "hmes_bench/run.py", "--workload",
         "table2-omnetpp.run", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=root, capture_output=True, text=True, timeout=300)


def test_cli_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        return      # on a card the command runs the cell (the cuda test)
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout == "", out


def test_bare_checkout_prints_no_result(tmp_path):
    """BENCHMARK.json and the benchmark's own files alone: the program is
    missing, and no run may print a result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hmes_bench", tmp_path / "hmes_bench")
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == "", out
