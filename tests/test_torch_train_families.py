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
import pytest

from test_torch_train_loss import check_loss_and_grads


@pytest.mark.parametrize("arch", ["rwkv6_7b", "hymba_1p5b",
                                  "deepseek_v2_236b", "phi35_moe_42b"])
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)
