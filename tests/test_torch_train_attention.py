"""The port's attention backward against the JAX package's, on the CPU.

``repro_torch.models.chunked_attention``'s gradients (its
``torch.autograd.Function``, the reference's blocked ``custom_vjp``) are
held to ``jax.vjp`` of ``repro.models.chunked_attention.chunked_attention``
on the same numpy inputs and the same upstream gradient, as
``tests/test_chunked_attention.py`` covers the reference: MHA and GQA, a
window, q the tail of kv, a ragged block (``block_q`` not dividing S:
one block), and a key width apart from the value width. float32: within
``F32_REL`` (1e-5) of each gradient's largest magnitude (the two sides
sum the products in different orders); bfloat16 inputs: within 2^-6.
The port's own gradient is also held to float64 autograd through
``naive_attention`` within 1e-5, and ``kernels.ops.flash_attention``'s
gradient (on the CPU its plain forward; its backward the plain version
recomputed in float32) to ``chunked_attention``'s within
``ref.kernel_error``'s allowance, in bfloat16 at GQA 4:1 as on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import chunked_attention as j_ca

from repro_torch.kernels import ops, ref
from repro_torch.models import chunked_attention as t_ca
from test_torch_models import BF16_REL, F32_REL, _close

CASES = {
    # name: (hq, hkv, s, skv, d, dv, window, block_q)
    "mha": (4, 4, 64, 64, 16, 16, None, 16),
    "gqa": (4, 2, 64, 64, 16, 16, None, 16),
    "window": (4, 4, 64, 64, 16, 16, 24, 16),
    "gqa_window": (8, 2, 96, 96, 16, 16, 10, 32),
    "tail_of_kv": (2, 2, 48, 96, 32, 32, None, 16),
    "ragged": (4, 2, 40, 40, 16, 16, 7, 16),
    "dk_neq_dv": (2, 2, 32, 32, 24, 16, None, 8),
}


def _inputs(case, seed=0):
    hq, hkv, s, skv, d, dv, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    mk = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return mk(2, hq, s, d), mk(2, hkv, skv, d), mk(2, hkv, skv, dv), \
        mk(2, hq, s, dv)


def _port_grads(q, k, v, g, window, block_q, scale, dtype):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True)
          for x in (q, k, v)]
    out = t_ca.chunked_attention(*ts, causal=True, window=window,
                                 scale=scale, block_q=block_q)
    out.backward(torch.from_numpy(g).to(dtype))
    return out, [t.grad for t in ts]


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_jax_vjp(case):
    hq, hkv, s, skv, d, dv, window, block_q = CASES[case]
    q, k, v, g = _inputs(case)
    scale = d ** -0.5
    out, grads = _port_grads(q, k, v, g, window, block_q, scale,
                             torch.float32)
    fn = lambda q, k, v: j_ca.chunked_attention(
        q, k, v, causal=True, window=window, scale=scale, block_q=block_q)
    jout, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    _close(out, jout, F32_REL, f"{case} out")
    for name, a, b in zip("qkv", grads, jgrads):
        _close(a, b, F32_REL, f"{case} d{name}")


@pytest.mark.parametrize("case", ["gqa", "gqa_window"])
def test_backward_bf16_matches_jax_vjp(case):
    hq, hkv, s, skv, d, dv, window, block_q = CASES[case]
    q, k, v, g = _inputs(case, seed=1)
    scale = d ** -0.5
    _, grads = _port_grads(q, k, v, g, window, block_q, scale,
                           torch.bfloat16)
    fn = lambda q, k, v: j_ca.chunked_attention(
        q, k, v, causal=True, window=window, scale=scale, block_q=block_q)
    _, vjp = jax.vjp(fn, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g, jnp.bfloat16))
    for name, a, b in zip("qkv", grads, jgrads):
        assert a.dtype == torch.bfloat16
        _close(a, b, BF16_REL, f"{case} d{name}")


@pytest.mark.parametrize("case", ["gqa_window", "ragged", "dk_neq_dv"])
def test_backward_matches_float64_naive(case):
    """The blocked backward against autograd through the S x S form."""
    hq, hkv, s, skv, d, dv, window, block_q = CASES[case]
    q, k, v, g = _inputs(case, seed=2)
    _, grads = _port_grads(q, k, v, g, window, block_q, d ** -0.5,
                           torch.float32)
    ts = [torch.from_numpy(x).double().requires_grad_(True)
          for x in (q, k, v)]
    b, _, sq, _ = ts[0].shape
    logits = torch.einsum("bkgqd,bktd->bkgqt",
                          ts[0].reshape(b, hkv, hq // hkv, sq, d), ts[1]) \
        * d ** -0.5
    qi = torch.arange(sq)[:, None] + (skv - sq)
    ki = torch.arange(skv)[None, :]
    logits = torch.where(t_ca._mask(qi, ki, True, window), logits, -1e30)
    out = torch.einsum("bkgqt,bktd->bkgqd", torch.softmax(logits, -1), ts[2])
    out.reshape(b, hq, sq, dv).backward(torch.from_numpy(g).double())
    for name, a, t in zip("qkv", grads, ts):
        _close(a, t.grad, F32_REL, f"{case} d{name} vs float64")


def test_no_grad_path_keeps_its_forward():
    """Without autograd the forward is the same blocked computation."""
    q, k, v, _ = _inputs("gqa_window", seed=3)
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    with torch.no_grad():
        a = t_ca.chunked_attention(*ts, window=10, block_q=32)
    out, _ = t_ca._fwd_blocks(ts[0].reshape(2, 2, 4, 96, 16), ts[1], ts[2],
                              True, 10, 16 ** -0.5, 32)
    assert torch.equal(a, out.reshape(2, 8, 96, 16))


@pytest.mark.parametrize("window", [None, 9])
def test_flash_gradient_within_kernel_allowance_of_chunked(window):
    """bfloat16 GQA 4:1: the flash entry's backward sums a group's dk and
    dv in float32 and rounds once, as ``chunked_attention``'s does (head
    by head in bfloat16 it stood 3 bfloat16 steps off dv)."""
    rng = np.random.default_rng(4)
    mk = lambda *shape, s=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).bfloat16()
    q, k, v = mk(2, 8, 32, 16), mk(2, 2, 32, 16), mk(2, 2, 32, 16)
    g = mk(2, 8, 32, 16, s=1e-3)

    def grads(fn):
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fn(*ins), ins, g)
    flash = grads(lambda *t: ops.flash_attention(*t, causal=True,
                                                 window=window))
    chunked = grads(lambda *t: t_ca.chunked_attention(
        *t, causal=True, window=window, block_q=16))
    for name, a, b in zip("qkv", flash, chunked):
        assert a.dtype == torch.bfloat16
        assert ref.kernel_error("attention", a, b)[1] <= 1.0, name
