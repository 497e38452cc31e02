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

from repro_torch.kernels import ops as t_ops, ref as t_ref, rwkv_scan as t_rw
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
    """The wrapper's count of the output block's shared memory: ~105 KB at
    chunk 128 and rwkv6 width, two blocks to an SM; chunk 256 (the prefix
    sum's limit) still fits the H100's 227 KB opt-in limit at width 64. At
    width 128 chunk 128 fits and chunk 144 does not, and the wrapper
    refuses it by name on the card."""
    limit = 227 * 1024
    assert t_rw.smem_bytes(128, 64, 64) == 107_264
    assert 2 * t_rw.smem_bytes(128, 64, 64) <= limit
    assert t_rw.smem_bytes(256, 64, 64) <= limit
    assert t_rw.smem_bytes(128, 128, 128) <= limit
    assert t_rw.smem_bytes(144, 128, 128) > limit
    assert t_rw.smem_bytes(192, 128, 128) > limit


# The CUDA kernel's decomposition, mirrored in plain PyTorch: launch 1
# forms each chunk's own state term U_n = kt^T v and total decay tot_n,
# launch 2 scans the states S_{n+1} = S_n exp(tot_n) + U_n element by
# element, launch 3 forms out = (att v + diag v) + qp S_n chunk by chunk.

def _tf32(x):
    """Round float32 to TF32 (10-bit mantissa, nearest, ties away from
    zero), as ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_exact(a, b):
    return a @ b


def _mm_3xtf32(drop_lo_hi=False):
    """A float32 product as the kernel's tensor cores take it: each
    operand split into hi = tf32(x) and lo = tf32(x - hi), the products of
    the parts exact and summed in float32, hi lo + lo hi + hi hi;
    ``drop_lo_hi`` leaves out the a_lo b_hi term."""
    def mm(a, b):
        a_hi, b_hi = _tf32(a), _tf32(b)
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        acc = a_hi @ b_lo
        if not drop_lo_hi:
            acc = acc + a_lo @ b_hi
        return acc + a_hi @ b_hi
    return mm


def _three_pass(r, k, v, logw, u, c, mm=_mm_exact, mm_att=None):
    """Output of the chunked scan through the kernel's three launches;
    ``mm`` takes the four chunk products, ``mm_att`` (default ``mm``) the
    att product alone."""
    mm_att = mm_att or mm
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    n = s // c
    rc, kc, lw = (x.reshape(b, h, n, c, dk).float() for x in (r, k, logw))
    vc = v.reshape(b, h, n, c, dv).float()
    cum = t_models_rwkv.prefix_sum(lw, 3)
    tot = cum[:, :, :, -1]
    # launch 1
    kt = kc * torch.exp(tot[:, :, :, None] - cum)
    own = mm(kt.transpose(-1, -2), vc)                      # U_n
    # launch 2
    state = torch.zeros((b, h, dk, dv))
    entering = []
    for i in range(n):
        entering.append(state)
        state = state * torch.exp(tot[:, :, i])[..., None] + own[:, :, i]
    entering = torch.stack(entering, 2)                     # S_n
    # launch 3
    qp = rc * torch.exp(cum - lw)
    kp = kc * torch.exp(-cum)
    att = mm_att(qp, kp.transpose(-1, -2))
    att = torch.where(torch.tril(torch.ones(c, c, dtype=torch.bool), -1),
                      att, 0.0)
    diag = ((rc * kc) * u.float()[None, :, None, None, :]).sum(-1)
    out = (mm(att, vc) + diag[..., None] * vc) + mm(qp, entering)
    return out.reshape(b, h, s, dv)


def _model_inputs(seed, heads, s=4096, d=64):
    """rwkv6-7b width (64 heads of 64) and its decay, -exp(decay_base +
    dd) with decay_base = linspace(-6, -1) over the 4,096 channels and dd
    ~ N(0, 0.5^2), on the heads ``heads`` (chip_smoke.rwkv_case's
    distribution); N(0, 1) r, k, v and u ~ 0.3 N(0, 1)."""
    rng = np.random.default_rng(seed)
    h = len(heads)
    base = np.linspace(-6.0, -1.0, 64 * d, dtype=np.float32).reshape(
        64, 1, d)[list(heads)]
    r, k, v = (rng.standard_normal((1, h, s, d)).astype(np.float32)
               for _ in range(3))
    dd = rng.standard_normal((1, h, s, d)).astype(np.float32) * 0.5
    logw = (-np.exp(base[None] + dd)).astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.3).astype(np.float32)
    return r, k, v, logw, u


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_three_pass_decomposition_matches_reference(dtype):
    """The kernel's three launches, in plain float32, give the jnp
    reference's output within 1e-6 of its largest magnitude: rwkv6 width,
    chunk 128, 8 chunks."""
    js, ts = _both(_model_inputs(20, (0, 21, 42, 63), s=1024), dtype)
    want = torch.from_numpy(np.array(j_ref_scan(*js, 128)[0], np.float32))
    got = _three_pass(*ts, 128)
    err = float((got - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max()), err


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_three_pass_one_chunk_matches_reference(dtype):
    """A sequence shorter than the chunk is one chunk of S tokens (64
    under chunk 128): no chunk state term, the state entering it 0; the
    three launches still give the jnp reference's output within 1e-6 of
    its largest magnitude."""
    js, ts = _both(_model_inputs(22, (0, 63), s=64), dtype)
    want = torch.from_numpy(np.array(j_ref_scan(*js, 128)[0], np.float32))
    got = _three_pass(*ts, 64)
    err = float((got - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max()), err


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_three_pass_3xtf32_within_card_allowance(dtype):
    """The four chunk products taken as 3xTF32 (the kernel's tensor-core
    products) stay within the card's allowance of the reference
    (``ref.kernel_error("rwkv")``, 1e-5 of max |plain|) at rwkv6-7b
    width, 4,096 tokens, chunk 128, on the slowest- and fastest-decaying
    heads; with the a_lo b_hi term of the att product left out they do
    not, so the allowance sees a dropped term."""
    js, ts = _both(_model_inputs(21, (0, 1, 62, 63)), dtype)
    want = torch.from_numpy(np.array(j_ref_scan(*js, 128)[0], np.float32))
    _, share = t_ref.kernel_error("rwkv", _three_pass(
        *ts, 128, mm=_mm_3xtf32()), want)
    assert share <= 1.0, share
    _, dropped = t_ref.kernel_error("rwkv", _three_pass(
        *ts, 128, mm=_mm_3xtf32(), mm_att=_mm_3xtf32(drop_lo_hi=True)),
        want)
    assert dropped > 1.0, dropped
