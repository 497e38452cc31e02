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
import torch.nn.functional as F

from repro.kernels import ops as j_ops, ref as j_ref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_attention import flash_attention as j_flash

from repro_torch.kernels import decode_attention as t_da
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from test_torch_rwkv import _mm_3xtf32, _tf32

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
                bq=64, bk=64, fn=t_ops.flash_attention):
    q, k, v = _arrays(seed, shape_q, shape_kv, shape_kv)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    got = fn(tq, tk, tv, causal=causal, window=window)
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


# ------------------------------------------------------------ kernel designs
def _split_partial(q, k, v, scale):
    """One split's fp32 partial (m, l, acc): q [G, D] against the split's
    rows k, v [n, D]; (-1e30, 0, 0) when n is 0."""
    g, d = q.shape
    if k.shape[0] == 0:
        return torch.full((g,), t_ref.NEG_INF), torch.zeros(g), \
            torch.zeros(g, d)
    s = (q.float() @ k.float().T) * scale
    m = s.max(dim=-1).values
    p = torch.exp(s - m[:, None])
    return m, p.sum(dim=-1), p @ v.float()


def _split_decode(q, kc, vc, lens, window):
    """The CUDA decode kernel's function in PyTorch: every split's plain
    partial, then ``combine_partials`` (fp32)."""
    b, hq, d = q.shape
    _, hkv, smax, _ = kc.shape
    g = hq // hkv
    scale = d ** -0.5
    n_split, length = t_da.split_plan(b, hkv, smax, window)
    out = torch.empty(b, hq, d)
    for bi in range(b):
        ranges = t_da.split_ranges(int(lens[bi]), smax, n_split, length,
                                   window)
        for h in range(hkv):
            qg = q[bi, h * g:(h + 1) * g]
            parts = [_split_partial(qg, kc[bi, h, r0:max(r0, r1)],
                                    vc[bi, h, r0:max(r0, r1)], scale)
                     for r0, r1 in ranges]
            m = torch.stack([p[0] for p in parts], dim=-1)      # [G, n]
            l = torch.stack([p[1] for p in parts], dim=-1)
            acc = torch.stack([p[2] for p in parts], dim=-2)    # [G, n, D]
            out[bi, h * g:(h + 1) * g] = t_da.combine_partials(m, l, acc)
    return out


@pytest.mark.parametrize("window", [None, 100])
def test_decode_split_combine_matches_pallas(window):
    """The split plan and the combine of the CUDA decode kernel, composed
    from per-split plain attention, against the interpreted Pallas kernel
    at kv_len 0, 1, on a split boundary and at Smax, and against the jnp
    reference for kv_len >= 1, in fp32 within 2e-5."""
    b, hq, hkv, smax, d = 4, 8, 2, 1024, 32
    n_split, length = t_da.split_plan(b, hkv, smax, window)
    assert n_split > 1 and n_split * length >= min(smax, window or smax)
    lens = np.asarray([0, 1, 2 * length + (window or 0), smax], np.int32)
    q, kc, vc = _arrays(20, (b, hq, d), (b, hkv, smax, d), (b, hkv, smax, d))
    got = _split_decode(*map(torch.from_numpy, (q, kc, vc)), lens, window)
    kern = j_decode(*map(jnp.asarray, (q, kc, vc, lens)), window=window,
                    block_k=128, interpret=True)
    _close(got, kern, 2e-5, "vs the Pallas kernel")
    assert not got[0].any()                       # kv_len 0 gives 0
    want = j_ref.decode_attention(*map(jnp.asarray, (q, kc, vc, lens)),
                                  window=window)
    _close(got[1:], np.asarray(want)[1:], 2e-5, "vs the jnp reference")


def test_decode_split_ranges_cover_the_valid_rows():
    """Every valid row is in exactly one split and no masked row in any,
    for lengths around the split boundaries, with and without a window
    that crosses them."""
    smax = 4096
    for window in (None, 100, 1000):
        n_split, length = t_da.split_plan(2, 4, smax, window)
        for n in (0, 1, length - 1, length, length + 1, 3 * length + 5,
                  smax - 1, smax):
            rows = [r for r0, r1 in t_da.split_ranges(n, smax, n_split,
                                                      length, window)
                    for r in range(r0, r1)]
            lo = max(0, n - window) if window is not None else 0
            assert rows == list(range(lo, n)), (window, n)


def test_combine_partials_with_every_split_empty_is_zero():
    m = torch.full((3, 5), t_ref.NEG_INF)
    got = t_da.combine_partials(m, torch.zeros(3, 5), torch.zeros(3, 5, 8))
    assert torch.equal(got, torch.zeros(3, 8))


def test_flash_hi_lo_split_of_p_stays_in_the_allowance():
    """Why the CUDA flash kernel's P V product runs twice: with P rounded
    to bfloat16 the output leaves ``ref.kernel_error``'s bfloat16
    allowance many times over (at outputs near zero); with P split into
    hi = bf16(P) and lo = bf16(P - hi), summed in fp32, it stays inside."""
    s, d = 256, 64
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _arrays(2, *[(1, 2, s, d)] * 3))
    want = t_ref.attention(q, k, v)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d ** -.5
    causal = torch.arange(s)[None, :] <= torch.arange(s)[:, None]
    logits = torch.where(causal, logits, t_ref.NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))   # as the kernel
    l = p.sum(-1, keepdim=True)
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    split = ((hi @ v.float() + lo @ v.float()) / l).bfloat16()
    rounded = ((hi @ v.float()) / l).bfloat16()
    assert t_ref.kernel_error("attention", split, want)[1] <= 1.0
    assert t_ref.kernel_error("attention", rounded, want)[1] > 10.0


def test_kernel_debug_build_traps_instead_of_hanging(monkeypatch):
    """REPRO_KERNEL_DEBUG=1 builds the flash and decode kernels, whose
    producer and consumers meet at mbarriers, with a bounded spin in every
    wait (``hopper.cuh``), into a library of another name."""
    from repro_torch.kernels import build
    monkeypatch.delenv("REPRO_KERNEL_DEBUG", raising=False)
    plain = {k.name: k.library for k in (t_fa.KERNEL, t_da.KERNEL)}
    monkeypatch.setenv("REPRO_KERNEL_DEBUG", "1")
    assert "-DREPRO_HANG_TRAP" in build.nvcc_flags()
    for k in (t_fa.KERNEL, t_da.KERNEL):
        assert k.library != plain[k.name]
        assert '#include "hopper.cuh"' in k.source.read_text()
    assert "__trap()" in (build.CSRC / "hopper.cuh").read_text()


# ------------------------------------------------------------ flash paths
# The CUDA flash kernel's two paths in plain PyTorch. "mma" (fp32, and
# bf16 at D % 8 != 0): 128-row q tiles, the kv tiles of Tile<Dp>::BK rows
# that the TPU skip rule visits, every product 3xTF32. "wgmma" (bf16 at
# D % 8 == 0): built for D 64, 128 or 256, the columns past D zeros.
MMA_BK = {16: 64, 32: 64, 64: 64, 96: 32, 128: 64, 192: 32, 256: 16}


def _mm_tf32(a, b):
    """a @ b as one TF32 product (the kernel's ``tf32()`` rounding)."""
    return _tf32(a) @ _tf32(b)


def _mma_mirror(q, k, v, *, causal=True, window=None, scale=None,
                mm_qk=_mm_3xtf32(), mm_pv=_mm_3xtf32()):
    """The "mma" path's arithmetic: q, k, v in float32, zero-padded to
    Dp columns; per 128-row q tile the kv tiles [first, last] of the TPU
    rule at BK rows; S = Q K^T * scale and O += P V, each product 3xTF32
    (``test_torch_rwkv._mm_3xtf32``, the kernel's ``tf32()`` rounding
    bit for bit) unless ``mm_qk`` / ``mm_pv`` say otherwise; masked
    logits -1e30 (keys past Skv do not exist); the online softmax; out =
    O * (1 / l), l = 0 giving 0, in q's type."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dp = next(p for p in MMA_BK if d <= p)
    bk = MMA_BK[dp]
    scale = d ** -0.5 if scale is None else scale
    qf, kf, vf = (F.pad(x.float(), (0, dp - d)) for x in (q, k, v))
    kf, vf = (x.repeat_interleave(hq // hkv, dim=1) for x in (kf, vf))
    out = torch.zeros(b, hq, sq, dp)
    q_off = skv - sq
    for q0 in range(0, sq, 128):
        rows = min(128, sq - q0)
        qi = torch.arange(q0, q0 + rows)[:, None] + q_off
        first, last = 0, (skv + bk - 1) // bk - 1
        if causal:
            last = min(last, (q0 + rows - 1 + q_off) // bk)
        if window is not None:
            first = max(0, q0 + q_off - window + 1) // bk
        m = torch.full((b, hq, rows), t_ref.NEG_INF)
        l = torch.zeros(b, hq, rows)
        o = torch.zeros(b, hq, rows, dp)
        for t in range(first, last + 1):
            kt = kf[:, :, t * bk:(t + 1) * bk]
            vt = vf[:, :, t * bk:(t + 1) * bk]
            s = mm_qk(qf[:, :, q0:q0 + rows], kt.transpose(-1, -2)) * scale
            ki = torch.arange(t * bk, t * bk + kt.shape[2])[None, :]
            keep = torch.ones(rows, kt.shape[2], dtype=torch.bool)
            if causal:
                keep &= ki <= qi
            if window is not None:
                keep &= qi - ki < window
            s = torch.where(keep, s, t_ref.NEG_INF)
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - mx)
            p = torch.exp(s - mx[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + mm_pv(p, vt)
            m = mx
        out[:, :, q0:q0 + rows] = o * (1.0 / torch.where(l == 0, 1.0, l))[
            ..., None]
    return out[..., :d].to(q.dtype)


def _wgmma_padded(q, k, v, *, causal=True, window=None, scale=None):
    """The "wgmma" path's function at D % 8 == 0: q, k and v zero-padded
    to the least of 64, 128 and 256 >= D, the caller's scale (D^-0.5 of
    the true D), the padded output columns dropped."""
    d = q.shape[-1]
    dp = next(p for p in (64, 128, 256) if d <= p)
    pq, pk, pv = (F.pad(x, (0, dp - d)) for x in (q, k, v))
    out = t_ref.attention(pq, pk, pv, causal=causal, window=window,
                          scale=d ** -0.5 if scale is None else scale)
    return out[..., :d]


def _phi3_inputs(seed, heads, s=2048, d=96):
    """phi3-mini width (head dim 96) on ``heads`` heads, N(0, 1)."""
    q, k, v = (torch.from_numpy(x) for x in _arrays(
        seed, *[(1, heads, s, d)] * 3))
    return q, k, v


def test_flash_mma_3xtf32_within_card_allowance():
    """The mma path's arithmetic (every product 3xTF32, TF32 rounding
    emulated bit for bit) at phi3-mini width, causal over 2,048 tokens,
    stays within ``ref.kernel_error``'s float32 allowance (2e-5) of the
    plain float32 attention."""
    q, k, v = _phi3_inputs(30, 2)
    want = t_ref.attention(q, k, v)
    err, share = t_ref.kernel_error("attention", _mma_mirror(q, k, v), want)
    assert share <= 1.0, (err, share)


@pytest.mark.parametrize("plain", ["qk", "pv"])
def test_flash_mma_one_tf32_product_misses_the_allowance(plain):
    """Why every product is split: with either one (Q K^T or P V) taken
    as a single TF32 product, the same attention leaves the float32
    allowance."""
    q, k, v = _phi3_inputs(30, 2)
    want = t_ref.attention(q, k, v)
    kw = {"mm_qk" if plain == "qk" else "mm_pv": _mm_tf32}
    err, share = t_ref.kernel_error("attention",
                                    _mma_mirror(q, k, v, **kw), want)
    assert share > 1.0, (err, share)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape_q,shape_kv,window", [
    ((1, 2, 128, 96), (1, 2, 128, 96), None),     # phi3-mini's head dim
    ((1, 4, 256, 20), (1, 2, 256, 20), 100),      # D % 8 != 0, GQA, window
    ((1, 4, 64, 32), (1, 2, 192, 32), 80),        # continuation
])
def test_flash_mma_mirror_matches_jax(dtype, shape_q, shape_kv, window):
    """The mma path's arithmetic against the interpreted Pallas kernel and
    the jnp reference."""
    _flash_case(31, dtype, shape_q, shape_kv, window=window, fn=_mma_mirror)


def test_flash_mma_mirror_noncausal_matches_jax():
    _flash_case(32, "float32", (2, 2, 128, 8), (2, 1, 128, 8),
                causal=False, fn=_mma_mirror)


def test_flash_bf16_zero_padded_head_dim_equals_unpadded():
    """bf16 attention at D 96 with q, k and v zero-padded to 128 columns
    and the scale kept at 96^-0.5 (the wgmma path built for 128) equals
    the unpadded plain result: the zero columns add exactly 0 to Q K^T."""
    q, k, v = (x.bfloat16() for x in _phi3_inputs(33, 2, s=256))
    got = _wgmma_padded(q, k, v)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, t_ref.attention(q, k, v))


@pytest.mark.parametrize("d", [32, 80, 96])
def test_flash_wgmma_padded_matches_jax(d):
    """The wgmma path's function at head dims below its tile width, in
    bf16, against the interpreted Pallas kernel and the jnp reference."""
    _flash_case(34, "bfloat16", (1, 4, 128, d), (1, 2, 128, d), window=96,
                fn=_wgmma_padded)
