"""The port's examples (``examples/*_torch.py``) on the CPU
(``--device cpu``), their printed rows held to the JAX examples' at the
same arguments, line for line. The JAX package draws its synthetic traces
with its own random bits, so where an example draws a trace from a seed
(``workload_trace``, ``generate``) the port's example is handed the JAX
package's trace; ``churn_trace`` and the serving workload draw with
numpy and need nothing. Every row is then equal bit for bit: the
emulator's outputs are exact and the reports' floats are the same
float32 values."""
import dataclasses
import importlib.util
import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

from repro.trace import TraceSpec as JTraceSpec, generate as j_generate
from repro.trace import workload_trace as j_workload_trace

import repro_torch.core as tcore

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
PORTED = ("quickstart", "policy_exploration", "serve_continuous",
          "wear_leveling", "endurance_lifetime")


@pytest.fixture
def examples_path(monkeypatch):
    monkeypatch.chdir(ROOT)
    monkeypatch.syspath_prepend(str(EXAMPLES))


def load(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t_trace(jtrace):
    return tcore.Trace(*(torch.as_tensor(np.array(x)) for x in jtrace))


def _lines(text: str) -> list[str]:
    # The CSV path and the package's name in the "written to" line are
    # the only text that differs by design.
    return [ln for ln in text.splitlines() if "written to" not in ln]


def run_port(name, argv, capsys, **patch):
    mod = load(f"{name}_torch")
    for attr, fn in patch.items():
        setattr(mod, attr, fn)
    capsys.readouterr()
    mod.main(["--device", "cpu", *argv])
    return _lines(capsys.readouterr().out)


def run_jax(name, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return _lines(capsys.readouterr().out)


def test_quickstart_rows_match_jax(examples_path, capsys, monkeypatch):
    def workload_trace(name, scale, min_requests, device):
        jt, w, n = j_workload_trace(name, scale=scale,
                                    min_requests=min_requests)
        return _t_trace(jt), w, n
    got = run_port("quickstart", [], capsys, workload_trace=workload_trace)
    want = run_jax("quickstart", [], capsys, monkeypatch)
    assert got == want
    assert len(got) == 18 and got[-1].startswith("NVM=flash")


def test_policy_exploration_rows_match_jax(examples_path, capsys,
                                           monkeypatch, tmp_path):
    def generate(spec, device=None):
        return _t_trace(j_generate(JTraceSpec(**dataclasses.asdict(spec))))
    argv = ["--requests", "2048"]
    got = run_port("policy_exploration", [*argv, "--out",
                                          str(tmp_path / "t.csv")],
                   capsys, generate=generate)
    want = run_jax("policy_exploration", [*argv, "--out",
                                          str(tmp_path / "j.csv")],
                   capsys, monkeypatch)
    assert got == want
    assert any(ln.startswith("hot_threshold=8192") for ln in got)
    from repro.sweep import load_rows as j_load
    from repro_torch.sweep import load_rows as t_load
    assert t_load(tmp_path / "t.csv") == j_load(tmp_path / "j.csv")


def test_serve_continuous_rows_match_jax(examples_path, capsys,
                                         monkeypatch):
    got = run_port("serve_continuous", [], capsys)
    want = run_jax("serve_continuous", [], capsys, monkeypatch)
    assert got == want
    assert got[-1].endswith("recompiles after warmup 0")


def test_wear_leveling_rows_match_jax(examples_path, capsys, monkeypatch):
    argv = ["--requests", "4096"]
    got = run_port("wear_leveling", argv, capsys)
    want = run_jax("wear_leveling", argv, capsys, monkeypatch)
    assert got == want
    assert len(got) == 20


def test_endurance_lifetime_rows_match_jax(examples_path, capsys,
                                           monkeypatch):
    argv = ["--requests", "4096"]
    got = run_port("endurance_lifetime", argv, capsys)
    want = run_jax("endurance_lifetime", argv, capsys, monkeypatch)
    assert got == want
    assert len(got) == 20


def test_churn_trace_is_the_jax_examples(examples_path):
    """``wear_leveling_torch.churn_trace`` draws the JAX example's trace
    (the wear-level tests load that one)."""
    j, t = load("wear_leveling"), load("wear_leveling_torch")
    cfg = tcore.EmulatorConfig(n_fast_pages=64, n_slow_pages=448)
    want = j.churn_trace(cfg, 3000, hot_w=96, period=512, write_frac=0.7,
                         seed=3)
    got = t.churn_trace(cfg, 3000, hot_w=96, period=512, write_frac=0.7,
                        seed=3)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", PORTED)
def test_example_runs_on_the_card_by_default(examples_path, name):
    """``--device`` defaults to ``cuda``: without a card the example stops
    before it runs, naming the CPU option."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load(f"{name}_torch").main([])
