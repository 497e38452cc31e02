"""The port's RWKV6 chunked scan against the JAX package.

The same numpy inputs go through the port's ``ops.rwkv_chunk`` (plain
PyTorch on the CPU, ``models.rwkv.rwkv_chunk_scan``) and through both JAX
functions: the Pallas kernel in interpret mode and the jnp reference
``repro.models.rwkv.rwkv_chunk_scan``. Tolerances are the JAX kernel
test's: 1e-5 in float32, 3e-2 in bfloat16. The CUDA kernel runs only on a
card: ``tests/test_torch_cuda.py`` holds it against its plain version
there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan import rwkv_chunk_scan as j_pallas_scan
from repro.models.rwkv import rwkv_chunk_scan as j_ref_scan

from repro_torch.kernels import ops as t_ops, rwkv_scan as t_rw
from repro_torch.models import rwkv as t_models_rwkv

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(seed, b=2, h=2, s=64, d=16):
    """The JAX kernel test's distribution: N(0, 1) r, k, v; log-decay
    -exp(N(0, 1) - 1.5); bonus u ~ 0.3 N(0, 1) in float32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    logw = (-np.exp(rng.standard_normal((b, h, s, d)) - 1.5)).astype(
        np.float32)
    u = (rng.standard_normal((h, d)) * 0.3).astype(np.float32)
    return r, k, v, logw, u


def _both(xs, dtype):
    jd, td = DTYPES[dtype]
    *rkvw, u = xs
    return ([jnp.asarray(x, jd) for x in rkvw] + [jnp.asarray(u)],
            [torch.from_numpy(x).to(td) for x in rkvw] + [torch.from_numpy(u)])


@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_chunk_matches_jax(chunk, dtype):
    js, ts = _both(_inputs(5), dtype)
    got = t_ops.rwkv_chunk(*ts, chunk=chunk)
    assert got.dtype == torch.float32
    kern = j_pallas_scan(*js, chunk=chunk, interpret=True)
    want, _ = j_ref_scan(*js, chunk)
    for what, w in (("vs the Pallas kernel", kern),
                    ("vs the jnp reference", want)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w, np.float32),
                                   atol=TOL[dtype], err_msg=what)


@pytest.mark.parametrize("chunk,s", [(16, 64), (32, 48), (128, 40)])
def test_rwkv_plain_output_and_state_match_jax_reference(chunk, s):
    """Output and final state of the plain scan, including the chunk
    that does not divide S (the reference then takes c = S)."""
    js, ts = _both(_inputs(6, s=s), "float32")
    out, state = t_models_rwkv.rwkv_chunk_scan(*ts, chunk)
    want, want_state = j_ref_scan(*js, chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                               atol=1e-5)


@pytest.mark.parametrize("n", [5, 16, 33, 128, 300])
def test_prefix_sum_equals_jnp_cumsum_bit_for_bit(n):
    """The port's (and the CUDA kernel's) summation order is the one
    jnp.cumsum takes on the CPU, so the decays agree exactly."""
    x = _inputs(7, b=1, h=2, s=n, d=5)[3]
    got = t_models_rwkv.prefix_sum(torch.from_numpy(x), 2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.cumsum(x, axis=2)))


def test_rwkv_cuda_launcher_rejects_cpu_tensors():
    _, ts = _both(_inputs(8), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        t_rw.rwkv_chunk_scan_cuda(*ts, chunk=16)


def test_rwkv_kernel_shared_memory_need():
    """The wrapper's count of the kernel's shared memory: ~212 KB at chunk
    128 and rwkv6 width, which fits the H100's 227 KB opt-in limit; chunk
    140 does not, and the wrapper refuses it by name on the card."""
    assert t_rw.smem_bytes(128, 64, 64) == 216_832
    assert t_rw.smem_bytes(140, 64, 64) > 227 * 1024
    assert t_rw.smem_bytes(192, 64, 64) > 227 * 1024
