"""The port's attention entry points against the JAX package.

The same numpy inputs go through the port's ``ops.flash_attention`` and
``ops.decode_attention`` (plain PyTorch on the CPU) and through both JAX
functions: the Pallas kernel in interpret mode and the jnp reference.
Tolerances are the JAX kernel tests': 2e-5 in float32, 2e-2 in bfloat16
(both frameworks round the same float32 inputs to bfloat16 and compute in
float32, but round the output at different points). The CUDA kernels run
only on a card: ``tests/test_torch_cuda.py`` holds them against their
plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops, ref as j_ref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_attention import flash_attention as j_flash

from repro_torch.kernels import decode_attention as t_da
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close(got_t, want_j, tol, what):
    got = got_t.detach().float().numpy()
    want = np.asarray(want_j, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=tol, err_msg=what)


def _flash_case(seed, dtype, shape_q, shape_kv, *, causal=True, window=None,
                bq=64, bk=64):
    q, k, v = _arrays(seed, shape_q, shape_kv, shape_kv)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    got = t_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == DTYPES[dtype][1]
    kern = j_flash(jq, jk, jv, causal=causal, window=window, block_q=bq,
                   block_k=bk, interpret=True)
    want = j_ref.attention(jq, jk, jv, causal=causal, window=window)
    _close(got, kern, TOL[dtype], "vs the Pallas kernel")
    _close(got, want, TOL[dtype], "vs the jnp reference")


# ------------------------------------------------------------ flash
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bk", [
    (1, 2, 2, 128, 32, 64, 64),
    (2, 4, 2, 256, 64, 128, 128),     # GQA 2:1
    (1, 8, 1, 128, 64, 64, 32),       # MQA
    (2, 2, 2, 192, 16, 64, 64),       # 3 blocks
    (1, 4, 2, 128, 96, 64, 64),       # head dim 96 (phi3-mini)
])
def test_flash_attention_matches_jax(dtype, b, hq, hkv, s, d, bq, bk):
    _flash_case(hash((b, hq, s, d)) % 2**32, dtype, (b, hq, s, d),
                (b, hkv, s, d), bq=bq, bk=bk)


@pytest.mark.parametrize("window", [32, 96])
def test_flash_attention_window_matches_jax(window):
    _flash_case(0, "float32", (1, 2, 256, 32), (1, 2, 256, 32),
                window=window)


def test_flash_attention_noncausal_matches_jax():
    _flash_case(1, "float32", (1, 2, 128, 32), (1, 2, 128, 32),
                causal=False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 80])
def test_flash_attention_continuation_matches_jax(dtype, window):
    """q is the tail of the kv sequence: q_off = Skv - Sq = 128."""
    _flash_case(2, dtype, (1, 4, 64, 32), (1, 2, 192, 32), window=window)


@pytest.mark.parametrize("window", [None, 48])
def test_flash_attention_gradient_matches_jax(monkeypatch, window):
    """torch autograd through the port's flash_attention against jax.vjp
    of repro.kernels.ops.flash_attention on its kernel path (interpreted
    Pallas forward, reference-recompute backward)."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    q, k, v, g = _arrays(3, (1, 4, 128, 32), (1, 2, 128, 32),
                         (1, 2, 128, 32), (1, 4, 128, 32))
    out_j, vjp = jax.vjp(
        lambda q, k, v: j_ops.flash_attention(q, k, v, window=window),
        *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out_t = t_ops.flash_attention(tq, tk, tv, window=window)
    out_t.backward(torch.from_numpy(g))
    _close(out_t, out_j, 2e-5, "forward")
    for name, t, j in zip("qkv", (tq, tk, tv), grads_j):
        _close(t.grad, j, 2e-5, f"d{name}")


def test_flash_attention_gradient_equals_plain_autograd():
    """The backward re-runs the plain version: the same gradients as
    autograd straight through ref.attention, bit for bit."""
    q, k, v, g = _arrays(4, (2, 4, 64, 16), (2, 1, 64, 16), (2, 1, 64, 16),
                         (2, 4, 64, 16))
    grads = []
    for fn in (t_ops.flash_attention, t_ref.attention):
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        fn(*xs, window=24).backward(torch.from_numpy(g))
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ------------------------------------------------------------ decode
def _decode_case(seed, dtype, b, hq, hkv, smax, d, bk, *, window=None,
                 kv_len=None):
    q, kc, vc = _arrays(seed, (b, hq, d), (b, hkv, smax, d),
                        (b, hkv, smax, d))
    rng = np.random.default_rng(seed + 1)
    lens = np.asarray(kv_len if kv_len is not None
                      else rng.integers(1, smax + 1, b), np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, kc, vc))
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)
    got = t_ops.decode_attention(tq, tk, tv, tl, window=window)
    assert got.dtype == DTYPES[dtype][1]
    kern = j_decode(jq, jk, jv, jl, window=window, block_k=bk,
                    interpret=True)
    want = j_ref.decode_attention(jq, jk, jv, jl, window=window)
    _close(got, kern, TOL[dtype], "vs the Pallas kernel")
    _close(got, want, TOL[dtype], "vs the jnp reference")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hq,hkv,smax,d,bk", [
    (2, 4, 2, 512, 64, 128),
    (1, 8, 8, 256, 32, 64),
    (3, 4, 1, 384, 128, 128),
    (2, 4, 2, 256, 96, 64),           # head dim 96
])
def test_decode_attention_matches_jax(dtype, b, hq, hkv, smax, d, bk):
    _decode_case(hash((b, hq, smax, d)) % 2**32, dtype, b, hq, hkv, smax, d,
                 bk)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_window_matches_jax(dtype):
    _decode_case(2, dtype, 2, 4, 2, 512, 64, 128, window=128,
                 kv_len=[200, 512])


def test_decode_attention_gqa_window_short_sequences():
    """Windowed GQA with sequences shorter than the window and of one
    token."""
    _decode_case(5, "float32", 3, 8, 2, 256, 32, 64, window=100,
                 kv_len=[1, 60, 256])


def test_decode_attention_kv_len_zero_is_the_reference_mean():
    """The plain version follows the JAX reference at kv_len = 0 (the
    mean of V); the Pallas and CUDA kernels return 0 there."""
    q, kc, vc = _arrays(6, (1, 2, 16), (1, 2, 64, 16), (1, 2, 64, 16))
    lens = np.zeros(1, np.int32)
    got = t_ops.decode_attention(*map(torch.from_numpy, (q, kc, vc, lens)))
    want = j_ref.decode_attention(*map(jnp.asarray, (q, kc, vc, lens)))
    _close(got, want, 2e-5, "kv_len 0")
    _close(got, vc.mean(axis=2), 2e-5, "mean of V")
    kern = j_decode(*map(jnp.asarray, (q, kc, vc, lens)), block_k=64,
                    interpret=True)
    assert not np.asarray(kern).any()


# ------------------------------------------------------------ the CUDA side
@pytest.mark.parametrize("entry", ["flash", "decode"])
def test_kernel_allowance_catches_a_dropped_kv_tile(entry):
    """``ref.kernel_error``, the limit the CUDA kernels are held to on the
    card, in bfloat16 over 8k keys (|out| ~ 0.015): the same attention
    with its keys summed in another order passes, the same attention with
    one 64-row kv tile left out fails (in decode it stays inside an
    absolute 2e-2)."""
    skv = 8192
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _arrays(
        9, (2, 4, 64) if entry == "decode" else (1, 4, 128, 64),
        (2, 2, skv, 64), (2, 2, skv, 64)))
    if entry == "decode":
        def attend(k, v):
            n = torch.full((2,), k.shape[2], dtype=torch.int32)
            return t_ref.decode_attention(q, k, v, n)
    else:
        q = q.expand(2, -1, -1, -1).contiguous()

        def attend(k, v):
            return t_ref.attention(q, k, v, causal=False)
    want = attend(k, v)
    perm = torch.randperm(skv, generator=torch.Generator().manual_seed(0))
    err, share = t_ref.kernel_error("attention", attend(k[:, :, perm],
                                                        v[:, :, perm]), want)
    assert 0 < err and share <= 1.0
    keep = torch.cat([torch.arange(4096), torch.arange(4160, skv)])
    err, share = t_ref.kernel_error("attention", attend(k[:, :, keep],
                                                        v[:, :, keep]), want)
    assert share > 1.0
    assert entry == "flash" or err < 2e-2


@pytest.mark.parametrize("launch", ["flash", "decode"])
def test_cuda_launchers_reject_cpu_tensors(launch):
    q, k = _arrays(7, (1, 2, 64, 16), (1, 2, 64, 16))
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    with pytest.raises(ValueError, match="CUDA"):
        if launch == "flash":
            t_fa.flash_attention_cuda(tq, tk, tk)
        else:
            t_da.decode_attention_cuda(tq[:, :, 0], tk, tk,
                                       torch.ones(1, dtype=torch.int32))
