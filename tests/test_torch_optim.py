"""The port's optimizer and gradient compression against the JAX
package's, on the CPU.

- ``adamw_update`` against ``jax.jit(repro.optim.adamw_update)`` on the
  same trees (float32 and bfloat16 parameters, clipping on and off):
  parameters and moments bit for bit (the port takes XLA's compiled
  order: its folded division and its four fused multiply-adds, each
  rounded once), and ``lr`` too, given the reference's global norm. The
  norm itself is a float32 sum whose order XLA shares with no other
  program: the port sums in float64, within 1e-6 of the exact norm and
  1e-5 of the reference's (measured: 10 float32 ulps on a bfloat16
  tree).
- ``warmup_cosine`` against the jitted schedule at every step of four
  horizons: within 1 float32 ulp (XLA's own float32 ``cos`` can be one
  ulp from the correctly rounded one the port takes); equal at every
  warmup step.
- ``clip_by_global_norm`` against the reference within 1e-6 relative
  (the port sums the squares in float32 in float64).
- ``compress_int8`` / ``decompress_int8`` bit for bit against the
  reference (round half to even); stochastic rounding unbiased.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as J

from repro_torch import optim as T
from repro_torch.optim import adamw as TA

SHAPES = {"a": (300, 70), "b": {"c": (513,), "d": (4, 9, 11)}}


def _tree(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _torch(tree, dtype=None):
    return _tree(lambda x: torch.from_numpy(np.array(x, copy=True)).to(
        dtype or torch.float32), tree)


def _bits(x):
    a = np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                   else np.asarray(x, np.float32), np.float32)
    return a.view(np.int32)


CASES = [
    # (gradient scale, starting step, config, parameter dtype)
    (1e-3, 0, {}, "float32"),
    (1e-1, 7, {}, "float32"),
    (1.0, 150, {"warmup_steps": 20, "total_steps": 1000}, "float32"),
    (1e-1, 3, {"weight_decay": 0.0, "clip_norm": 0.5}, "bfloat16"),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_adamw_update_is_bitwise_jit(case, monkeypatch):
    gscale, step0, extra, dtype = CASES[case]
    rng = np.random.default_rng(case)
    p = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    g = _tree(lambda s: (rng.standard_normal(s) * gscale).astype(np.float32))
    mu = _tree(lambda s: (rng.standard_normal(s) * 1e-3).astype(np.float32))
    nu = _tree(lambda s: (rng.random(s) * 1e-5).astype(np.float32))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jcfg = J.AdamWConfig(lr_peak=3e-4, **extra)
    tcfg = T.AdamWConfig(lr_peak=3e-4, **extra)
    jp, js, jm = jax.jit(lambda p, g, s: J.adamw_update(jcfg, p, g, s))(
        jax.tree.map(lambda x: jnp.asarray(x, jdt), p),
        jax.tree.map(lambda x: jnp.asarray(x, jdt), g),
        J.adamw.OptState(jax.tree.map(jnp.asarray, mu),
                         jax.tree.map(jnp.asarray, nu), jnp.int32(step0)))
    gn = float(T.global_norm(_torch(g, tdt)))
    exact = np.sqrt(sum(np.sum(np.square(np.asarray(
        x.float(), np.float64))) for _, x in _leaves(_torch(g, tdt))))
    assert abs(gn - exact) <= 1e-6 * exact
    assert abs(gn - float(jm["grad_norm"])) <= 1e-5 * exact
    monkeypatch.setattr(TA, "global_norm", lambda grads: torch.tensor(
        np.asarray(jm["grad_norm"])))
    tp, ts, tm = T.adamw_update(
        tcfg, _torch(p, tdt), _torch(g, tdt),
        T.OptState(_torch(mu), _torch(nu),
                   torch.tensor(step0, dtype=torch.int32)))
    assert int(ts.step) == int(js.step) == step0 + 1
    assert ts.step.dtype == torch.int32
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for (path, a), (_, b) in zip(_leaves(got),
                                     _leaves(jax.tree.map(np.asarray, want))):
            assert a.dtype == (tdt if got is tp else torch.float32)
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=path)
    assert float(tm["lr"]) == float(jm["lr"])
    assert float(tm["grad_norm"]) == float(jm["grad_norm"])


def test_adamw_update_is_in_place():
    params = {"w": torch.randn(5, 3)}
    state = T.init_opt_state(params)
    ids = (params["w"].data_ptr(), state.mu["w"].data_ptr())
    p2, s2, _ = T.adamw_update(T.AdamWConfig(), params,
                               {"w": torch.randn(5, 3)}, state)
    assert (p2["w"].data_ptr(), s2.mu["w"].data_ptr()) == ids
    assert s2.mu["w"].dtype == s2.nu["w"].dtype == torch.float32


def test_adamw_optimizes_quadratic():
    cfg = T.AdamWConfig(lr_peak=0.1, warmup_steps=5, total_steps=200,
                        weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    state = T.init_opt_state(params)
    for _ in range(150):
        params, state, _ = T.adamw_update(cfg, params,
                                          {"w": 2 * params["w"]}, state)
    assert float((params["w"] ** 2).sum()) < 1e-2


@pytest.mark.parametrize("horizon", [(10, 100, 1e-3), (20, 1000, 3e-4),
                                     (6, 30, 3e-4), (100, 10_000, 3e-4)])
def test_warmup_cosine_within_one_ulp_of_jit(horizon):
    warm, total, peak = horizon
    jcfg = J.AdamWConfig(lr_peak=peak, warmup_steps=warm, total_steps=total)
    tcfg = T.AdamWConfig(lr_peak=peak, warmup_steps=warm, total_steps=total)
    fn = jax.jit(lambda s: J.warmup_cosine(jcfg, s))
    steps = sorted(set(range(0, min(total, 300) + 3))
                   | set(range(0, total + 3, max(1, total // 200))))
    got = np.array([_bits(T.warmup_cosine(tcfg, s)) for s in steps])
    want = np.array([_bits(fn(jnp.int32(s))) for s in steps])
    assert np.abs(got - want).max() <= 1
    assert np.array_equal(got[:warm], want[:warm])


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0), "b": torch.full((9,), 10.0,
                                                      dtype=torch.bfloat16)}
    clipped, gn = T.clip_by_global_norm(g, 1.0)
    assert clipped["b"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(gn), 10.0 * np.sqrt(13), rtol=1e-6)
    total = torch.sqrt(sum((x.float() ** 2).sum() for x in clipped.values()))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-2)
    rng = np.random.default_rng(0)
    tree = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    jc, jgn = J.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 2.0)
    tc, tgn = T.clip_by_global_norm(_torch(tree), 2.0)
    np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
    for (path, a), (_, b) in zip(_leaves(tc),
                                 _leaves(jax.tree.map(np.asarray, jc))):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, err_msg=path)


@pytest.mark.parametrize("shape", [(100,), (33, 7), (256, 4), (1000, 37)])
def test_int8_compression_is_bitwise(shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    x.reshape(-1)[:256] = 0.0                      # an all-zero block
    jq, js, jmeta = J.compress_int8(jnp.asarray(x))
    tq, ts, tmeta = T.compress_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tmeta == (tuple(shape), x.size)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    y = T.decompress_int8(tq, ts, tmeta)
    np.testing.assert_array_equal(
        _bits(y), _bits(J.decompress_int8(jq, js, jmeta)))
    err = np.abs(y.numpy() - x)
    step = np.repeat(ts.numpy(), 256)[:x.size].reshape(shape)
    assert np.all(err <= 0.51 * step + 1e-12)


def test_int8_stochastic_rounding_unbiased():
    x = torch.full((256,), 0.3e-2)                 # between two codes
    gen = torch.Generator().manual_seed(0)
    ys = [float(T.decompress_int8(*T.compress_int8(x, gen)).mean())
          for _ in range(50)]
    assert abs(np.mean(ys) - 0.3e-2) < 0.02e-2
    q1 = T.compress_int8(x, torch.Generator().manual_seed(5))[0]
    q2 = T.compress_int8(x, torch.Generator().manual_seed(5))[0]
    assert torch.equal(q1, q2)                     # the generator's bits
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(1000)
                         .astype(np.float32))
    q, scale, _ = T.compress_int8(r, gen)
    y = torch.cat([r, r.new_zeros(24)]).reshape(-1, 256) / scale[:, None]
    up = q.float() - torch.floor(y)
    assert set(up.flatten().tolist()) == {0.0, 1.0}   # floor or ceil
