"""The port's training objective against the JAX package's, on the CPU:
the other families (``test_torch_train_loss.py`` holds the dense ones,
with the same rule and tolerances).

rwkv6 (the chunked scan and the channel mix, in place writes under
autograd), hymba (attention + the Mamba scan, windows), deepseek-v2 (MLA,
MoE with shared experts and its aux loss) and phi3.5-moe (GQA + MoE):
``loss_fn``'s value, ``ce``, ``aux`` and every gradient leaf within
``F32_REL`` (1e-5) of each tensor's largest magnitude of
``jax.jit(jax.value_and_grad(repro.models.loss_fn))``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ShardCtx as JShard
from repro.models import transformer as JT

from repro_torch.convert import model_params_from_numpy
from repro_torch.models import ShardCtx
from repro_torch.models import transformer as TT
from test_torch_models import leaves
from test_torch_train_loss import batch_of, check_loss_and_grads, configs_of

# ||g - g_ref|| / ||g_ref|| of a gradient leaf: the measure (and bound)
# chip_smoke.py's phase 12 holds the card's training gradients to.
GRAD_REL = 2.0 ** -5


@pytest.mark.parametrize("arch", ["rwkv6_7b", "hymba_1p5b",
                                  "deepseek_v2_236b", "phi35_moe_42b"])
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)



def _jax_grads(jcfg, params, batch):
    fn = jax.jit(jax.grad(lambda p, b: JT.loss_fn(jcfg, p, b, JShard())[0]))
    return dict(leaves(jax.tree.map(
        lambda g: np.asarray(g, np.float32),
        fn(params, jax.tree.map(jnp.asarray, batch)))))


def test_rwkv6_bf16_grads_round_where_jax_does():
    """rwkv6 in bfloat16 at width 1,024 (one layer): every gradient leaf
    within ``GRAD_REL`` of JAX's bfloat16 gradients. At this width the r
    and k paths' gradients are ill-conditioned in the activation
    roundings: JAX's own float32 gradients miss its bfloat16 ones by more
    than ``GRAD_REL`` (asserted), so a port that rounds elsewhere than
    the reference (the norms, each step of the token-shift lerp, the
    projections, the log-decay, the gate, the residuals) misses too.
    chip_smoke.py's phase 12 copies these rounding points into its
    float64 reference for rwkv6-7b's bfloat16 gradients."""
    wide = dict(n_layers=1, d_model=1024, n_heads=16, n_kv_heads=16,
                head_dim=64, d_ff=1024)
    jcfg, tcfg = configs_of("rwkv6_7b", "bfloat16")
    jcfg, tcfg = jcfg.with_(**wide), tcfg.with_(**wide)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    batch = batch_of(jcfg)
    want = _jax_grads(jcfg, params, batch)
    j32 = _jax_grads(jcfg.with_(param_dtype="float32",
                                activation_dtype="float32"),
                     jax.tree.map(lambda x: x.astype(jnp.float32), params),
                     batch)

    tp = model_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    flat = [t.requires_grad_(True) for _, t in leaves(tp)]
    loss, _ = TT.loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, ShardCtx())
    grads = torch.autograd.grad(loss, flat)
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    misses = {}
    for (path, t), g in zip(leaves(tp), grads):
        assert g.dtype == t.dtype, path
        got = rel(g.float().numpy(), want[path])
        assert got <= GRAD_REL, (path, got / GRAD_REL)
        misses[path] = rel(j32[path], want[path])
    assert max(misses.values()) > GRAD_REL, misses
