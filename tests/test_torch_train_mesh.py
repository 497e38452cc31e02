"""Training over a ``torch.distributed`` mesh, on the CPU.

Every case spawns its ranks (``launch.mesh.run_ranks``: ``gloo``, a
``FileStore`` under ``tmp_path``) with a join time limit of its own. The
JAX package's own mesh training cannot run with this JAX
(``tests/test_elastic.py`` fails inside its sharding API), so the port is
held to the reference's unsharded functions under ``jit``:

* the mesh ``make_train_step`` (weights held by ``param_specs``, moments
  and gradients by ``zero1_specs``: ZeRO-1/2) against JAX's unsharded
  ``make_train_step``, from the same weights (``convert.
  model_params_from_numpy``) and batches, for internlm2 (data 2 x model
  2, 2 micro-batches), hymba (3 heads: context-parallel attention, and
  Mamba's ``in_proj`` split), rwkv6 and deepseek-v2 (MLA, experts and
  shared experts, ``fsdp=True``, at a capacity factor that drops
  nothing): the losses at rtol 1e-4 (``tests/test_elastic.py``'s bar), the
  first step's global gradients within 1e-5 of their largest magnitude,
  every rank's stored blocks equal to its block of the gathered result,
  and the bytes a rank holds equal to what the specs say;
* ZeRO-1 alone: on the same full gradients the sharded ``adamw_update``,
  gathered back, equals the unsharded one bit for bit, and the sharded
  global norm counts every element once (equal to the unsharded norm);
* ``compressed_psum_spec`` over a 2-rank ``"pod"`` axis: each rank's int8
  blocks and scales bit for bit JAX's ``compress_int8`` with no key, the
  sum equal to the dequantised blocks' sum, and within 2% of the exact
  sum (``tests/test_grad_compression.py``'s bar), stochastic rounding
  too;
* the elastic restart through ``launch.train.run --mesh dev``,
  ``tests/test_elastic.py``'s scenario at its sizes: 8 steps on (data 2,
  model 2) with checkpoints, resumed on (data 1, model 4) to step 14,
  against a straight 14 steps on (2, 2) (losses at rtol 1e-4, final
  parameters within ``F32_REL`` of each leaf's largest); the mesh's
  checkpoint loads on one device in the port and in
  ``repro.ckpt.load_checkpoint``.

AdamW's ``eps`` is 1e-3 in the step cases, as in
``tests/test_torch_train_step.py`` (a gradient within its tolerance of
zero may step either way at 1e-8).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.ckpt import load_checkpoint as j_load_checkpoint
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import ShardCtx as JShard
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamW
from repro.optim import compress as j_compress
from repro.optim import init_opt_state as j_init_opt

import repro_torch.configs as TC
from repro_torch import dist as t_dist
from repro_torch.ckpt import load_checkpoint
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import mesh as M
from repro_torch.launch import shardings as TS
from repro_torch.launch import train as t_train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import ShardCtx, init_params
from repro_torch.models import sharding as TSh
from repro_torch.optim import (AdamWConfig, OptState, adamw_update,
                               global_norm, init_opt_state)
from repro_torch.optim import compress as t_compress
from repro_torch.tree import leaves as tree_leaves
from test_torch_models import F32_REL, _close, leaves

JOIN_S = 300          # each case's join time limit
OPT = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
STEPS = 3
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-5       # of the largest magnitude


def _run(tmp_path, fn, world, *args):
    return M.run_ranks(fn, world, args, timeout_s=JOIN_S, work_dir=tmp_path)


def _np(tree):
    return {p: t.detach().float().numpy() for p, t in leaves(tree)}


def _numel_bytes(shape, dtype_size, spec, sh):
    ways = 1
    for a in TSh.spec_axes(spec):
        ways *= sh.size(a)
    return int(np.prod(shape, dtype=np.int64)) * dtype_size // ways


def _held_bytes(tree, specs, shapes, sh, what):
    """Mismatches between each leaf's bytes and its whole size over the
    product of its spec's axis sizes."""
    bad = []
    for t, spec, shape in zip(tree_leaves(tree), tree_leaves(specs),
                              tree_leaves(shapes)):
        want = _numel_bytes(shape, t.element_size(), spec, sh)
        if t.numel() * t.element_size() != want:
            bad.append(f"{what} {spec} {tuple(t.shape)}: "
                       f"{t.numel() * t.element_size()} B, not {want}")
    return bad


# ------------------------------------------------------ the mesh train step
def _step_rank(rank, world, tp, cfg, fsdp, micro, params_np, batches):
    torch.set_num_threads(1)
    sh = ShardCtx.from_mesh(M.make_dev_mesh(model=tp))
    pspecs = TS.param_specs(cfg, sh, fsdp)
    shapes = TS.param_shapes(cfg)
    zspecs = TS.zero1_specs(pspecs, shapes, sh)
    full = model_params_from_numpy(params_np, "cpu")
    opt = init_opt_state(TS.shard_tree(full, zspecs, sh))
    params = TS.shard_tree(full, pspecs, sh)
    step = make_train_step(cfg, AdamWConfig(**OPT), sh.with_stored(pspecs),
                           micro_batches=micro, grad_specs=zspecs)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in batches]
    _, _, g0 = step.compute_grads(params, batches[0])
    bad = (_held_bytes(params, pspecs, shapes, sh, "params")
           + _held_bytes(opt.mu, zspecs, shapes, sh, "mu")
           + _held_bytes(g0, zspecs, shapes, sh, "grads"))
    out = {"grads": _np(TS.gather_tree(g0, zspecs, sh)), "losses": [],
           "grad_norms": []}
    sh.traffic.reset()
    for b in batches:
        params, opt, m = step(params, opt, b)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["traffic"] = sh.traffic.as_dict()
    whole = TS.gather_tree(params, pspecs, sh)
    mu = TS.gather_tree(opt.mu, zspecs, sh)
    for tree, w, specs, what in ((params, whole, pspecs, "params"),
                                 (opt.mu, mu, zspecs, "mu")):
        for (path, t), (_, wt), spec in zip(leaves(tree), leaves(w),
                                            tree_leaves(specs)):
            if not torch.equal(t, TSh.local_slice(wt, spec, sh)):
                bad.append(f"{what} {path}: the stored block is not the "
                           "rank's block of the gathered result")
    out.update(bad=bad, params=_np(whole))
    return out


def _jax_reference(jcfg, micro, params, batches):
    """JAX's unsharded step under jit over ``batches`` (losses, grad norms,
    final parameters) and its first batch's gradients, averaged over the
    micro-batches as its step averages them."""
    jstep = jax.jit(j_make_train_step(jcfg, JAdamW(**OPT), JShard(),
                                      micro_batches=micro))
    grad_fn = jax.jit(jax.grad(lambda p, b: JT.loss_fn(jcfg, p, b, JShard())[
        0]))
    b0 = batches[0]
    n = b0["labels"].shape[0] // micro
    grads = None
    for i in range(micro):
        g = grad_fn(params, {k: jnp.asarray(v[i * n:(i + 1) * n])
                             for k, v in b0.items()})
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    grads = jax.tree.map(lambda g: np.asarray(g, np.float32) / micro, grads)
    p, s = params, j_init_opt(params)
    losses, norms = [], []
    for b in batches:
        p, s, m = jstep(p, s, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, dict(leaves(grads)), dict(leaves(jax.tree.map(
        lambda x: np.asarray(x, np.float32), p)))


def _batches(cfg, b, s, n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"inputs": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
            for _ in range(n)]


def _no_drop(cfg):
    return cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


# name: (arch, overrides, model axis, micro-batches, fsdp, batch, seq)
STEP_CASES = {
    "internlm2": ("internlm2_1p8b", {}, 2, 2, None, 4, 16),
    # 3 heads divide no model axis of 2: context-parallel attention; the
    # Mamba inner width 48 does: in_proj, conv_w, ... split over "model"
    "hymba": ("hymba_1p5b", dict(n_heads=3, n_kv_heads=1), 2, 1, None, 4,
              16),
    "rwkv6": ("rwkv6_7b", {}, 2, 1, None, 4, 16),
    "deepseek": ("deepseek_v2_236b", {}, 2, 1, True, 4, 16),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_mesh_train_step_matches_jax(case, tmp_path):
    arch, over, tp, micro, fsdp, b, s = STEP_CASES[case]
    jcfg, cfg = JC.get_smoke(arch).with_(**over), \
        TC.get_smoke(arch).with_(**over)
    if cfg.moe:
        jcfg, cfg = _no_drop(jcfg), _no_drop(cfg)
    params = jax.tree.map(np.asarray,
                          JT.init_params(jcfg, jax.random.PRNGKey(0)))
    batches = _batches(cfg, b, s, STEPS)
    results = _run(tmp_path, _step_rank, 4, tp, cfg, fsdp, micro, params,
                   batches)
    jlosses, jnorms, jgrads, jparams = _jax_reference(jcfg, micro, params,
                                                      batches)
    sh = ShardCtx(axis_sizes=(("data", 4 // tp), ("model", tp)))
    pspecs = TS.param_specs(cfg, sh, fsdp)
    # the weights are held split, and some over "data" too under FSDP
    assert any(TSh.spec_axes(sp) for sp in tree_leaves(pspecs))
    if fsdp:
        assert all("data" in TSh.spec_axes(sp) or len(sp) == 0
                   for sp in tree_leaves(pspecs))
    for r in results:
        assert r["bad"] == []
        np.testing.assert_allclose(r["losses"], jlosses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norms"], jnorms, rtol=LOSS_RTOL)
        assert r["traffic"]["calls"]["reduce_scatter"] > 0      # ZeRO-2
        assert sorted(r["grads"]) == sorted(jgrads)
        for path, want in jgrads.items():
            tol = GRAD_TOL * max(np.abs(want).max(), 1e-30)
            np.testing.assert_allclose(r["grads"][path], want, rtol=0,
                                       atol=tol, err_msg=path)
        for path, got in r["params"].items():
            np.testing.assert_array_equal(got, results[0]["params"][path])
            _close(got, jparams[path], F32_REL, f"param {path}")


# ------------------------------------------------------------------ ZeRO-1
def _zero1_rank(rank, world, fsdp, cfg, trees):
    torch.set_num_threads(1)
    sh = ShardCtx.from_mesh(M.make_dev_mesh(model=2))
    pspecs = TS.param_specs(cfg, sh, fsdp)
    zspecs = TS.zero1_specs(pspecs, TS.param_shapes(cfg), sh)
    p, g, mu, nu = (model_params_from_numpy(t, "cpu") for t in trees)
    params = TS.shard_tree(p, pspecs, sh)
    g, mu, nu = (TS.shard_tree(t, zspecs, sh) for t in (g, mu, nu))
    state = OptState(mu, nu, torch.tensor(3, dtype=torch.int32))
    gn = global_norm(g, sh, zspecs)
    params, state, m = adamw_update(AdamWConfig(), params, g, state, sh,
                                    pspecs, zspecs)
    return {"norm": float(gn), "grad_norm": float(m["grad_norm"]),
            "params": _np(TS.gather_tree(params, pspecs, sh)),
            "mu": _np(TS.gather_tree(state.mu, zspecs, sh)),
            "nu": _np(TS.gather_tree(state.nu, zspecs, sh)),
            "traffic": sh.traffic.as_dict()}


@pytest.mark.parametrize("fsdp", [False, True])
def test_zero1_update_is_bitwise_the_unsharded_one(fsdp, tmp_path):
    cfg = TC.get_smoke("deepseek_v2_236b")
    rng = np.random.default_rng(1)
    shapes = TS.param_shapes(cfg)
    draw = lambda scale: jax.tree.map(
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    # gradients large enough that clipping binds
    trees = (draw(0.05), draw(1.0), draw(0.01), jax.tree.map(
        np.abs, draw(0.01)))
    results = _run(tmp_path, _zero1_rank, 4, fsdp, cfg, trees)
    p, g, mu, nu = (model_params_from_numpy(t, "cpu") for t in trees)
    whole_norm = float(global_norm(g))
    p, st, m = adamw_update(AdamWConfig(), p, g,
                            OptState(mu, nu, torch.tensor(3,
                                                          dtype=torch.int32)))
    assert float(m["grad_norm"]) > 1.0
    want = {"params": _np(p), "mu": _np(st.mu), "nu": _np(st.nu)}
    for r in results:
        assert r["norm"] == whole_norm == r["grad_norm"]
        assert r["traffic"]["calls"]["all_reduce_f64"] > 0
        for what, tree in want.items():
            for path, w in tree.items():
                np.testing.assert_array_equal(r[what][path].view(np.int32),
                                              w.view(np.int32),
                                              err_msg=f"{what} {path}")


# ------------------------------------------------------- compressed_psum
def _compress_rank(rank, world, grads_np):
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    sh = ShardCtx.from_mesh(init_device_mesh("cpu", (world,),
                                             mesh_dim_names=("pod",)))
    grads = {k: torch.from_numpy(v[rank]) for k, v in grads_np.items()}
    blocks = []
    real = t_compress.compress_int8

    def spy(x, gen=None):
        out = real(x, gen)
        if gen is None:
            blocks.append((out[0].numpy().copy(), out[1].numpy().copy()))
        return out
    t_compress.compress_int8 = spy
    try:
        det = t_compress.compressed_psum_spec(grads, sh, "pod")
        sto = t_compress.compressed_psum_spec(
            grads, sh, "pod", torch.Generator().manual_seed(rank))
    finally:
        t_compress.compress_int8 = real
    exact = {k: t_dist.all_reduce(v, sh, "pod") for k, v in grads.items()}
    flat = lambda tree: {k: v.numpy() for k, v in tree.items()}
    return {"det": flat(det), "sto": flat(sto), "exact": flat(exact),
            "blocks": blocks, "traffic": sh.traffic.as_dict()}


def test_compressed_psum_spec(tmp_path):
    rng = np.random.default_rng(2)
    # each rank's gradients at another magnitude, as data ranks' differ
    grads = {k: np.stack([rng.standard_normal(s).astype(np.float32)
                          * (1 + 2 * r) for r in range(2)])
             for k, s in (("a", (300, 70)), ("b", (513,)), ("c", (4, 9, 11)))}
    results = _run(tmp_path, _compress_rank, 2, grads)
    for rank, r in enumerate(results):
        assert r["traffic"]["calls"]["all_gather"] == 2 * len(grads) * 2
        for i, k in enumerate(sorted(grads)):
            q, scale = r["blocks"][i]
            jq, js, _ = j_compress.compress_int8(jnp.asarray(grads[k][rank]))
            np.testing.assert_array_equal(q, np.asarray(jq))
            np.testing.assert_array_equal(scale, np.asarray(js))
            deq = sum(np.asarray(j_compress.decompress_int8(
                *j_compress.compress_int8(jnp.asarray(grads[k][j]))))
                for j in range(2))
            np.testing.assert_array_equal(r["det"][k], deq)
            exact = r["exact"][k]
            np.testing.assert_allclose(exact, grads[k].sum(0), rtol=1e-6)
            for name in ("det", "sto"):
                err = np.abs(r[name][k] - exact).max() / np.abs(exact).max()
                assert err < 0.02, (name, k, err)
    for k in grads:
        np.testing.assert_array_equal(results[0]["det"][k],
                                      results[1]["det"][k])


# -------------------------------------------------------- elastic restart
ELASTIC = ["--arch", "internlm2-1.8b", "--smoke", "--batch", "4", "--seq",
           "32", "--log-every", "100", "--ckpt-every", "4", "--mesh", "dev",
           "--total-steps", "14", "--device", "cpu"]


def _elastic_rank(rank, world, ckpt):
    torch.set_num_threads(1)
    p8, _ = t_train.run(ELASTIC + ["--steps", "8", "--ckpt-dir", ckpt,
                                   "--mesh-model", "2"])
    p_elastic, loss_elastic = t_train.run(
        ELASTIC + ["--steps", "14", "--ckpt-dir", ckpt, "--mesh-model", "4"])
    p_ref, loss_ref = t_train.run(ELASTIC + ["--steps", "14",
                                             "--mesh-model", "2"])
    sh = ShardCtx.from_mesh(M.make_dev_mesh(model=4))
    coords = TSh.rank_coords(rank, sh.axis_sizes)
    lead = rank == 0
    return {"loss_elastic": loss_elastic, "loss_ref": loss_ref,
            "p8": _np(p8) if lead else None,
            "p_elastic": _np(p_elastic) if lead else None,
            "p_ref": _np(p_ref) if lead else None,
            "coords_agree": all(coords[a] == sh.coord(a) for a in sh.names)}


def test_elastic_restart_on_another_mesh(tmp_path):
    ckpt = str(tmp_path / "ck")
    results = _run(tmp_path, _elastic_rank, 4, ckpt)
    for r in results:
        assert r["coords_agree"]
        np.testing.assert_allclose(r["loss_elastic"], r["loss_ref"],
                                   rtol=LOSS_RTOL)
        assert r["loss_elastic"] == results[0]["loss_elastic"]
    # the losses alone miss a load that slices a leaf wrongly: a random
    # model's loss barely depends on its weights
    p_ref = results[0]["p_ref"]
    for path, t in results[0]["p_elastic"].items():
        _close(t, p_ref[path], what=path)
    p8 = results[0]["p8"]
    # the mesh's checkpoint is the file one device writes
    cfg = TC.get_smoke("internlm2_1p8b")
    template = init_params(cfg, torch.Generator(), "cpu")
    (tree, _), manifest = load_checkpoint(
        ckpt, (template, init_opt_state(template)), step=8)
    assert manifest["step"] == 8 and manifest["mesh"] == [["data", 2],
                                                          ["model", 2]]
    for path, t in leaves(tree):
        np.testing.assert_array_equal(t.numpy(), p8[path], err_msg=path)
    jcfg = JC.get_smoke("internlm2_1p8b")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    (jtree, _), _ = j_load_checkpoint(ckpt, (jparams, j_init_opt(jparams)),
                                      step=8)
    for path, t in leaves(jax.tree.map(np.asarray, jtree)):
        np.testing.assert_array_equal(t, p8[path], err_msg=path)
