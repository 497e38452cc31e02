"""The port's sharded model paths on a ``torch.distributed`` mesh, on the CPU.

Every case spawns its ranks (``launch.mesh.run_ranks``: ``gloo``, a
``FileStore`` under ``tmp_path``, no fixed port) with a join time limit of
its own, so a hung collective fails its test. The JAX package's own
sharded paths cannot run with this JAX (``tests/test_context_parallel.py``
and ``tests/test_moe_shardmap.py`` fail inside its sharding API), so the
port is held to the reference's unsharded functions and to its per-shard
functions composed here:

* context-parallel attention: musicgen's smoke config with 3 heads on
  data 2 x model 2 (``tests/test_context_parallel.py``'s case) and a
  Hymba smoke config whose 3 heads do not divide the model axis: the
  loss against JAX's unsharded ``loss_fn`` (rtol 2e-5) and every
  gradient, reduced over the ranks, within 1e-5 of its largest magnitude;
* the expert-parallel MoE: phi3.5-moe's smoke config at capacity factor
  8 (no token dropped) against JAX's dense ``loss_fn`` (loss and aux rtol
  2e-4, gradients atol 2e-4, ``tests/test_moe_shardmap.py``'s bars); at
  its own factor, where capacity binds, against JAX's ``_route_scatter``,
  ``_expert_ffn`` and ``_combine`` applied to each device's tokens with
  that device's capacity (what the reference's ``_moe_shard_map``
  computes: its all-to-alls only move expert blocks);
* ``dist_decode``'s combine: against JAX's ``_partial`` over each slice at
  its offset, combined in numpy as ``repro/models/decode.py`` does, and
  against the unsharded ``dist_decode``, with windows and lengths that
  straddle a shard boundary (``kv_len >= 1``);
* decoding end to end: a smoke GQA model's prefill and decode steps over
  a cache split on its sequence axis, and Hymba's rings split likewise,
  against JAX's ``prefill`` / ``decode_step``.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import ShardCtx as JShard
from repro.models import decode as j_dec
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models import transformer as JT

import repro_torch.configs as TC
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as t_steps
from repro_torch.models import ShardCtx
from repro_torch.models import decode as t_dec
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as TT
from test_torch_models import F32_REL, _close, leaves

JOIN_S = 240          # each case's join time limit


def _run(tmp_path, fn, world, *args):
    return M.run_ranks(fn, world, args, timeout_s=JOIN_S, work_dir=tmp_path)


def _mesh_ctx(tp):
    torch.set_num_threads(1)
    return ShardCtx.from_mesh(M.make_dev_mesh(model=tp))


def _tree_np(tree):
    return {p: t.detach().numpy() for p, t in leaves(tree)}


# ----------------------------------------------------------- loss and grads
def _loss_rank(rank, world, tp, cfg, params_np, batch_np):
    """One rank's ``loss_fn`` on its rows and its gradients reduced to the
    global loss's (``reduce_grads``); the MoE's dropped slots counted."""
    sh = _mesh_ctx(tp)
    dropped = []
    real = t_moe._route_scatter

    def counting(*a):
        out = real(*a)
        dropped.append(int((~out[4]).sum()))
        return out
    t_moe._route_scatter = counting
    params = TT.shard_params(cfg, model_params_from_numpy(params_np, "cpu"),
                             sh)
    rows = sh.batch_rows(batch_np["labels"].shape[0])
    batch = {k: torch.from_numpy(v[rows]) for k, v in batch_np.items()}
    flat = [t for _, t in leaves(params)]
    for t in flat:
        t.requires_grad_(True)
    loss, m = TT.loss_fn(cfg, params, batch, sh)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    grads = TT.reduce_grads(cfg, t_steps._rebuild(params, grads), sh)
    return {"loss": float(loss), "ce": float(m["ce"]), "aux": float(m["aux"]),
            "grads": _tree_np(grads), "traffic": sh.traffic.as_dict(),
            "model": sh.coord("model"), "dropped": sum(dropped),
            "cp": t_layers.use_context_parallel(
                cfg, sh, batch["labels"].shape[0], batch["labels"].shape[1])}


def _jax_loss_and_grads(jcfg, params, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(jcfg, p, b, JShard()), has_aux=True))
    (loss, m), grads = fn(params, jax.tree.map(jnp.asarray, batch))
    return float(loss), {k: float(v) for k, v in m.items()}, \
        dict(leaves(jax.tree.map(np.asarray, grads)))


def _expert_path(cfg, path):
    return bool(cfg.moe) and path.startswith("/layers/mlp/w_")


def _held_grads(cfg, results, tp):
    """The ranks' reduced gradients, each expert weight assembled from
    its model ranks' slices; every rank holding a leaf holds the same."""
    out = {}
    for path in results[0]["grads"]:
        if _expert_path(cfg, path):
            by_col = {}
            for r in results:
                prev = by_col.setdefault(r["model"], r["grads"][path])
                np.testing.assert_array_equal(prev, r["grads"][path])
            out[path] = np.concatenate([by_col[c] for c in range(tp)], 1)
        else:
            for r in results[1:]:
                np.testing.assert_array_equal(r["grads"][path],
                                              results[0]["grads"][path])
            out[path] = results[0]["grads"][path]
    return out


def _check(results, jloss, jm, jgrads, cfg, tp, loss_rtol, grad_tol):
    for r in results:
        np.testing.assert_allclose(r["loss"], jloss, rtol=loss_rtol)
        np.testing.assert_allclose(r["aux"], jm["aux"], rtol=loss_rtol,
                                   atol=1e-12)
    grads = _held_grads(cfg, results, tp)
    assert sorted(grads) == sorted(jgrads)
    for path, w in jgrads.items():
        w = np.asarray(w, np.float32)
        if grad_tol is None:
            _close(grads[path], w, F32_REL, f"grad {path}")
        else:
            np.testing.assert_allclose(grads[path], w, atol=grad_tol,
                                       err_msg=path)


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frames":
        inputs = rng.standard_normal((b, s, cfg.frame_dim)).astype(
            np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return {"inputs": inputs,
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


CP_CASES = {
    # tests/test_context_parallel.py's config: 3 heads, data 2 x model 2
    "musicgen": ("musicgen_medium", dict(n_heads=3, n_kv_heads=3, d_model=48,
                                         head_dim=16, d_ff=64), 2, 4, 16),
    # Hymba's smoke config has 4 heads, which divide 2: set 3
    "hymba": ("hymba_1p5b", dict(n_heads=3, n_kv_heads=1), 2, 2, 16),
}


@pytest.mark.parametrize("case", sorted(CP_CASES))
def test_context_parallel_matches_unsharded_jax(case, tmp_path):
    arch, over, tp, b, s = CP_CASES[case]
    jcfg, cfg = JC.get_smoke(arch).with_(**over), \
        TC.get_smoke(arch).with_(**over)
    params = jax.tree.map(np.asarray,
                          JT.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = _batch(jcfg, b, s)
    world = tp * (2 if case == "musicgen" else 1)
    results = _run(tmp_path, _loss_rank, world, tp, cfg, params, batch)
    assert all(r["cp"] for r in results), "the CP path must be taken"
    for r in results:
        t = r["traffic"]
        # one a layer, run again by the backward's recompute, and one
        # reduce-scatter a layer in the backward
        assert t["calls"]["all_gather"] == 2 * cfg.n_layers
        assert t["calls"]["reduce_scatter"] == cfg.n_layers
        assert t["round_trips"] == 0                      # CPU tensors
    jloss, jm, jgrads = _jax_loss_and_grads(jcfg, params, batch)
    _check(results, jloss, jm, jgrads, cfg, tp, 2e-5, None)


def _composed_moe(dp, tp):
    """The reference's ``_moe_shard_map`` written out on one device from its
    own per-shard functions: each (data, model) device's tokens routed
    with that device's capacity through every expert, combined, and the
    switch statistics averaged over the devices."""
    def moe_block(cfg, p, x, sh):
        e = cfg.moe
        b, s, d = x.shape
        bl, sl = b // dp, s // tp
        c_dev = max(4, int(bl * sl * e.top_k / e.n_experts *
                           e.capacity_factor))
        rows, mes, ces = [], [], []
        for i in range(dp):
            cols = []
            for j in range(tp):
                xt = x[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl].reshape(
                    bl * sl, d)
                buf, idx, gates, pos, keep, me, ce = j_moe._route_scatter(
                    cfg, p["router"], xt, c_dev)
                eo = j_moe._expert_ffn(p, buf, cfg.adtype)
                cols.append(j_moe._combine(eo, idx, gates, pos, keep,
                                           bl * sl, d, cfg.adtype
                                           ).reshape(bl, sl, d))
                mes.append(me)
                ces.append(ce)
            rows.append(jnp.concatenate(cols, 1))
        out = jnp.concatenate(rows, 0)
        aux = j_moe._aux_loss(cfg, sum(mes) / len(mes), sum(ces) / len(ces))
        if e.n_shared:
            out = out + j_layers.swiglu(x, p["shared"], sh, cfg.adtype)
        return out, aux
    return moe_block


@pytest.mark.parametrize("binding", [False, True])
def test_expert_parallel_moe(binding, tmp_path, monkeypatch):
    """phi3.5-moe's smoke config (4 experts, 2 a rank) on data 2 x model
    2: capacity factor 8 (nothing dropped) against JAX's dense
    ``loss_fn``; its own 1.25, where every device drops tokens, against
    the per-device composition."""
    over = dict(n_heads=4, n_kv_heads=2)
    jcfg, cfg = JC.get_smoke("phi35_moe_42b"), TC.get_smoke("phi35_moe_42b")
    if not binding:
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe,
                                                  capacity_factor=8.0))
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                capacity_factor=8.0))
    jcfg, cfg = jcfg.with_(**over), cfg.with_(**over)
    params = jax.tree.map(np.asarray,
                          JT.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = _batch(jcfg, 4, 16)
    results = _run(tmp_path, _loss_rank, 4, 2, cfg, params, batch)
    for r in results:
        assert r["grads"]["/layers/mlp/w_in"].shape[1] == 2  # its experts
        # two a layer forward, again in the recompute, two backward
        assert r["traffic"]["calls"]["all_to_all"] == 6 * cfg.n_layers
        assert (r["dropped"] > 0) == binding
    if binding:
        monkeypatch.setattr(j_moe, "moe_block", _composed_moe(2, 2))
    jloss, jm, jgrads = _jax_loss_and_grads(jcfg, params, batch)
    _check(results, jloss, jm, jgrads, cfg, 2, 2e-4, 2e-4)


# ------------------------------------------------------------- dist_decode
def _decode_rank(rank, world, q, k, v, kv_len, window):
    sh = _mesh_ctx(world)
    sl = k.shape[2] // world
    lo = sh.coord("model") * sl
    out = t_dec.dist_decode(
        torch.from_numpy(q), torch.from_numpy(k[:, :, lo:lo + sl]).clone(),
        torch.from_numpy(v[:, :, lo:lo + sl]).clone(),
        torch.from_numpy(kv_len), sh=sh, window=window)
    return {"out": out.numpy(), "traffic": sh.traffic.as_dict()}


def _numpy_combine(q, k, v, kv_len, window, tp):
    """JAX's ``_partial`` over each slice at its offset, combined as
    ``repro/models/decode.py`` does (max, then the corrected sums)."""
    sl = k.shape[2] // tp
    scale = q.shape[-1] ** -0.5
    w = None if window is None else jnp.int32(window)
    parts = [[np.asarray(a) for a in j_dec._partial(
        q, k[:, :, r * sl:(r + 1) * sl], v[:, :, r * sl:(r + 1) * sl],
        jnp.asarray(kv_len), jnp.full((1, 1, 1), r * sl, jnp.int32), w,
        scale)] for r in range(tp)]
    m_g = np.max([m for m, _, _ in parts], axis=0)
    l_g = sum(l * np.exp(m - m_g) for m, l, _ in parts)
    acc = sum(a * np.exp(m - m_g)[..., None] for m, _, a in parts)
    return acc / np.where(l_g == 0, 1, l_g)[..., None]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("window", [None, 3])
def test_dist_decode_combine(tp, window, tmp_path):
    """The sequence-split combine on ``tp`` model ranks against the
    composed partials and the unsharded ``dist_decode``: lengths of 1,
    at, one short of and one past a shard boundary, and the whole cache;
    a window across the boundary."""
    smax = 16
    sl = smax // tp
    rng = np.random.default_rng(tp + (window or 0))
    kv_len = np.array([1, sl - 1, sl, sl + 1, smax, 2 * sl + 2 if tp > 2
                       else smax - 3], np.int32)
    b = len(kv_len)
    q = rng.standard_normal((b, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((b, 2, smax, 16)).astype(np.float32)
            for _ in range(2))
    results = _run(tmp_path, _decode_rank, tp, q, k, v, kv_len, window)
    composed = _numpy_combine(q, k, v, kv_len, window, tp)
    whole = j_dec.dist_decode(q, k, v, jnp.asarray(kv_len), sh=JShard(),
                              window=window)
    for r in results:
        _close(r["out"], composed, F32_REL, "against the composed partials")
        _close(r["out"], whole, F32_REL, "against the unsharded combine")
        assert r["traffic"]["calls"]["all_reduce"] == 3
        np.testing.assert_array_equal(r["out"], results[0]["out"])


# ------------------------------------------------------ decoding end to end
B, S, SMAX, STEPS = 4, 12, 20, 3


def _serve_rank(rank, world, tp, cfg, params_np, prompt, steps):
    """Prefill on the rank's rows, then teacher-forced decode steps, over a
    cache split on its sequence axis."""
    sh = _mesh_ctx(tp)
    params = TT.shard_params(cfg, model_params_from_numpy(params_np, "cpu"),
                             sh)
    rows = sh.batch_rows(prompt.shape[0])
    logits, cache, pos = TT.prefill(cfg, params,
                                    torch.from_numpy(prompt[rows]), sh, SMAX)
    out = {"prefill": logits.numpy(), "decode": [], "data": sh.coord("data"),
           "model": sh.coord("model")}
    empty = TT.init_cache(cfg, len(prompt[rows]), SMAX, "cpu", sh)
    out["shapes"] = [(tuple(a.shape), tuple(b.shape))
                     for (_, a), (_, b) in zip(leaves(cache), leaves(empty))]
    for t in steps:
        lg, cache, pos = TT.decode_step(cfg, params,
                                        torch.from_numpy(t[rows]), cache,
                                        pos, sh)
        out["decode"].append(lg.numpy())
    out["cache"] = _tree_np(cache)
    return out


DECODE_CASES = {
    "minitron": ("minitron_8b", {}, 2, 4),          # data 2 x model 2
    "hymba": ("hymba_1p5b", dict(n_heads=3, n_kv_heads=1), 2, 2),
    # the recurrent state split by its 4 heads
    "rwkv6": ("rwkv6_7b", {}, 2, 4),
    # MLA's latent cache; capacity 8 drops no token, so the prefill's
    # expert-parallel MoE equals the dense one (a binding capacity is
    # held by test_expert_parallel_moe)
    "deepseek": ("deepseek_v2_236b", dict(moe=lambda c: dataclasses.replace(
        c.moe, capacity_factor=8.0)), 2, 4),
}


def _with(cfg, over):
    """``cfg`` with ``over`` applied; a callable value is of ``cfg``."""
    return cfg.with_(**{k: v(cfg) if callable(v) else v
                        for k, v in over.items()})


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_sharded_decode_matches_jax(case, tmp_path):
    """Prefill and ``STEPS`` decode steps (the cache's sequence axis, or
    Hymba's rings, split over the model axis: each rank writes only the
    rows it holds; Hymba's Mamba states split by their inner width and
    RWKV's state by its heads, each rank keeping its block) against JAX's unsharded ``prefill`` /
    ``decode_step``: logits within 1e-5 of their largest magnitude, each
    rank's cache equal to its slice of JAX's."""
    arch, over, tp, world = DECODE_CASES[case]
    jcfg = _with(JC.get_smoke(arch), over)
    cfg = _with(TC.get_smoke(arch), over)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    steps = [rng.integers(0, jcfg.vocab, (B,)).astype(np.int32)
             for _ in range(STEPS)]
    results = _run(tmp_path, _serve_rank, world, tp, cfg,
                   jax.tree.map(np.asarray, params), prompt, steps)
    sh = JShard()
    logits, cache, pos = jax.jit(
        lambda p, x: JT.prefill(jcfg, p, x, sh, SMAX))(params, prompt)
    dec = jax.jit(lambda p, t, c, q: JT.decode_step(jcfg, p, t, c, q, sh))
    want = []
    for t in steps:
        lg, cache, pos = dec(params, t, cache, pos)
        want.append(lg)
    jcache = dict(leaves(jax.tree.map(np.asarray, cache)))
    dp = world // tp
    for r in results:
        rows = slice(r["data"] * B // dp, (r["data"] + 1) * B // dp)
        _close(r["prefill"], np.asarray(logits)[rows], what="prefill")
        for i, (g, w) in enumerate(zip(r["decode"], want)):
            _close(g, np.asarray(w)[rows], what=f"decode step {i}")
        for (a, b) in r["shapes"]:
            assert a == b                  # prefill's slice = init_cache's
        for path, c in r["cache"].items():
            full = jcache[path][rows] if case == "hymba" else \
                jcache[path][:, rows]
            # the sequence axes, Hymba's Mamba states' inner width and
            # RWKV's state heads, which the model axis splits as
            # cache_specs does
            axis = {"k": 2, "v": 2, "c_kv": 1, "k_rope": 1, "conv": 2,
                    "ssm": 1, "state": 1}.get(path.rsplit("/", 1)[1])
            if axis is not None:
                if case != "hymba":
                    axis += 1              # stacked over layers
                n = full.shape[axis] // tp
                full = np.take(full, np.arange(r["model"] * n,
                                               (r["model"] + 1) * n), axis)
            _close(c, full, what=f"cache {path}")


# ------------------------------------------------------------- launching
def _hang_rank(rank, world):
    time.sleep(60)


def test_run_ranks_kills_a_hung_rank(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        M.run_ranks(_hang_rank, 2, timeout_s=5, work_dir=tmp_path)
    assert time.monotonic() - t0 < 40


def _fail_rank(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def test_run_ranks_raises_a_rank_failure(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails"):
        M.run_ranks(_fail_rank, 2, timeout_s=JOIN_S, work_dir=tmp_path)


def test_production_mesh_needs_its_world():
    with pytest.raises(ValueError, match="needs 256 ranks"):
        M.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        M.make_production_mesh(multi_pod=True)
