"""The port's training objective against the JAX package's, on the CPU:
the dense families.

For one smoke configuration of each family, ``loss_fn``'s value (with
its ``ce`` and ``aux``) and the gradient of every parameter leaf are held
to ``jax.jit(jax.value_and_grad(repro.models.loss_fn, has_aux=True))`` on
the same parameters (JAX's ``init_params``, carried over by
``convert.model_params_from_numpy``) and the same batch: float32 within
``F32_REL`` (1e-5) of each compared tensor's largest magnitude, the
bfloat16 case within ``BF16_REL`` (2^-6). A leaf the loss does not reach
(musicgen's token table under frame inputs) has a zero gradient on both
sides. This file: internlm2 (GQA, untied head), gemma3 (windows, the
tied head), musicgen (frames) and internlm2 in bfloat16;
``test_torch_train_families.py`` the others.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import ShardCtx as JShard
from repro.models import transformer as JT

import repro_torch.configs as TC
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import ShardCtx
from repro_torch.models import transformer as TT
from test_torch_models import BF16_REL, F32_REL, _close, leaves

B, S = 2, 16


def batch_of(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frames":
        inputs = rng.standard_normal((b, s, cfg.frame_dim)).astype(
            np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return {"inputs": inputs,
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def configs_of(arch, dtype=None):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    if dtype:
        jcfg = jcfg.with_(param_dtype=dtype, activation_dtype=dtype)
        tcfg = tcfg.with_(param_dtype=dtype, activation_dtype=dtype)
    return jcfg, tcfg


def check_loss_and_grads(arch, dtype=None):
    jcfg, tcfg = configs_of(arch, dtype)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    batch = batch_of(jcfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(jcfg, p, b, JShard()), has_aux=True))
    (jloss, jm), jgrads = fn(params, jax.tree.map(jnp.asarray, batch))

    tp = model_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    flat = [t for _, t in leaves(tp)]
    for t in flat:
        t.requires_grad_(True)
    loss, m = TT.loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, ShardCtx())
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    rel = BF16_REL if dtype else F32_REL
    assert loss.dtype == torch.float32
    for name, a, b in (("loss", loss, jloss), ("ce", m["ce"], jm["ce"]),
                       ("aux", m["aux"], jm["aux"])):
        _close(a.detach(), b, rel, f"{arch} {name}")
    jflat = list(leaves(jax.tree.map(np.asarray, jgrads)))
    assert [p for p, _ in leaves(tp)] == [p for p, _ in jflat]
    for (path, w), g, t in zip(jflat, grads, flat):
        assert g.dtype == t.dtype, path
        if not np.any(np.asarray(w, np.float32)):
            assert not torch.any(g), path
            continue
        _close(g, w, rel, f"{arch} grad {path}")


@pytest.mark.parametrize("arch", ["internlm2_1p8b", "gemma3_4b",
                                  "musicgen_medium"])
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


def test_loss_and_grads_bf16_match_jax():
    check_loss_and_grads("internlm2_1p8b", "bfloat16")


def test_forward_seq_recomputes_each_layer_under_autograd(monkeypatch):
    """With autograd recording, each layer runs once in the forward and
    once more in the backward; prefill and ``no_grad`` run it once."""
    _, cfg = configs_of("gemma3_4b")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    calls = []
    real = TT._seq_block
    monkeypatch.setattr(TT, "_seq_block",
                        lambda *a: calls.append(1) or real(*a))
    for _, t in leaves(params):
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in batch_of(cfg).items()}
    loss, _ = TT.loss_fn(cfg, params, batch, ShardCtx())
    assert len(calls) == cfg.n_layers
    loss.backward()
    assert len(calls) == 2 * cfg.n_layers
    calls.clear()
    TT.prefill(cfg, params, batch["inputs"], ShardCtx(), 32)
    with torch.no_grad():
        TT.loss_fn(cfg, params, batch, ShardCtx())
    assert len(calls) == 2 * cfg.n_layers
