"""The port's training step and launcher, on the CPU.

``launch.steps.make_train_step`` at 1 and 2 micro-batches (and a MoE
model at 2), three steps, against the reference's under ``jit`` from the
same parameters and batches, at AdamW's ``eps`` 1e-3 (see ``OPT``):
metrics (loss, ce, aux, grad_norm, lr) within ``F32_REL`` (1e-5)
relative, moments and parameters within ``F32_REL`` of each leaf's
largest magnitude.

The launcher: ``--device cpu`` reduces the loss as
``tests/test_system.py::test_training_reduces_loss`` checks the
reference; a crash at step 8 and a resume equal an uninterrupted run bit
for bit (loss and every parameter); ``--mesh dev`` without a process
group raises, naming how to start the ranks; without ``--device`` it
needs a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import ShardCtx as JShard
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamW
from repro.optim import init_opt_state as j_init_opt

import repro_torch.configs as TC
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import train as t_train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import ShardCtx
from repro_torch.optim import AdamWConfig, init_opt_state
from test_torch_models import F32_REL, _close, leaves

# eps 1e-3: Adam's step g / (|g| + eps) then moves by at most
# 2 * |dg| / eps for a gradient error dg, so the gradients' 1e-5 holds the
# parameters to 1e-5 too. At the default 1e-8 a gradient within its
# tolerance of zero may step either way (+-lr): that step is held bit for
# bit on equal gradients instead (test_torch_optim.py).
OPT = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
STEPS = 3


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.mark.parametrize("arch,micro", [("internlm2_1p8b", 1),
                                        ("internlm2_1p8b", 2),
                                        ("phi35_moe_42b", 2)])
def test_train_step_matches_jax(arch, micro):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jstep = jax.jit(j_make_train_step(jcfg, JAdamW(**OPT), JShard(),
                                      micro_batches=micro))
    tstep = make_train_step(tcfg, AdamWConfig(**OPT), ShardCtx(),
                            micro_batches=micro)
    jp, js = params, j_init_opt(params)
    tp = model_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    ts = init_opt_state(tp)
    rng = np.random.default_rng(0)
    for i in range(STEPS):
        x = rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
        batch = {"inputs": x, "labels": np.roll(x, -1, axis=1)}
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        assert int(ts.step) == i + 1
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert tm[k].dtype == torch.float32, k
            want = float(jm[k])
            assert abs(float(tm[k]) - want) <= F32_REL * abs(want), (i, k)
        for name, got, want in (("mu", ts.mu, js.mu), ("nu", ts.nu, js.nu)):
            for (path, a), (_, b) in zip(leaves(got),
                                         leaves(_np_tree(want))):
                _close(a, b, F32_REL, f"step {i} {name}{path}")
        for (path, a), (_, b) in zip(leaves(tp), leaves(_np_tree(jp))):
            _close(a, b, F32_REL, f"step {i} param{path}")


def test_training_reduces_loss():
    _, loss = t_train.run([
        "--arch", "internlm2-1.8b", "--smoke", "--steps", "30",
        "--batch", "8", "--seq", "64", "--log-every", "100",
        "--device", "cpu"])
    assert loss < 4.7      # ln(128) ~ 4.85 at init; structure is learnable


def test_crash_restart_resumes_bitwise(tmp_path):
    """Train 12 steps with a crash at 8 + resume == 12 uninterrupted, bit
    for bit on the CPU (also at 2 micro-batches)."""
    args = ["--arch", "internlm2-1.8b", "--smoke", "--batch", "4",
            "--seq", "32", "--log-every", "100", "--ckpt-every", "4",
            "--micro-batches", "2", "--device", "cpu"]
    d1 = str(tmp_path / "a")
    with pytest.raises(SystemExit):
        t_train.run(args + ["--steps", "12", "--ckpt-dir", d1,
                            "--simulate-failure-at", "8"])
    p_resumed, loss_resumed = t_train.run(args + ["--steps", "12",
                                                  "--ckpt-dir", d1])
    p_straight, loss_straight = t_train.run(args + ["--steps", "12"])
    assert loss_resumed == loss_straight
    for (path, a), (_, b) in zip(leaves(p_resumed), leaves(p_straight)):
        assert torch.equal(a, b), path


def test_mesh_raises_and_device_defaults_to_cuda(monkeypatch):
    # --mesh without a process group (no ranks started, not under
    # torchrun) raises, naming how to start the ranks
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
        t_train.run(["--arch", "internlm2-1.8b", "--smoke", "--mesh", "dev",
                     "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.run(["--arch", "internlm2-1.8b", "--smoke", "--steps", "1"])
