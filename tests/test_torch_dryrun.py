"""The production meshes' dry run (``repro_torch.launch.dryrun``), on the
CPU.

The JAX package's own dry run fails under this JAX
(``tests/test_system.py::test_dryrun_smoke_subprocess``), so the port is
held to what the JAX package computes without compiling, and to real
runs of the port itself:

* **held bytes a rank**: every cell's arguments (the weight blocks, the
  moments and the batch's rows for training; the weights and the inputs
  for prefill; the weights, the cache and the inputs for decode) on the
  16 x 16 and 2 x 16 x 16 meshes, for the ten configurations, equal to
  the bytes JAX's ``param_specs`` / ``zero1_specs`` / ``batch_specs`` /
  ``cache_specs`` give its ``jax.eval_shape`` trees (RWKV's decode
  state split by its heads and Hymba's Mamba states by their inner width
  included);
* **a small dry run against a real run**: a 4-rank fake dry run of a
  smoke configuration (data 2 x model 2) equals the same training step
  run for real on 4 gloo ranks (``launch.mesh.run_ranks``): the same
  FLOPs, the same result bytes of each collective and operand bytes of
  each ``dist.Traffic`` entry, the same held bytes;
* **the roofline's extrapolation**: ``roofline_costs`` from the counts
  at 1-4 layers equals the direct count at 6 layers;
* **the CLI**: the reference's smoke cell ``--arch internlm2-1.8b --shape
  decode_32k`` prints ``"status": "ok"`` in a subprocess; a group that
  already exists is refused.
"""
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as JC
from repro.configs.shapes import SHAPES as JSHAPES
from repro.data import DataConfig as JData, batch_specs as j_data_specs
from repro.launch import shardings as JS
from repro.models import ShardCtx as JShard
from repro.models import transformer as JT

import repro_torch.configs as TC
from repro_torch.configs.shapes import SHAPES, Shape
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import shardings as TS
from repro_torch.launch.steps import make_train_step
from repro_torch.models import ShardCtx, init_params
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.tree import tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 300
AXES = {False: (("data", 16), ("model", 16)),
        True: (("pod", 2), ("data", 16), ("model", 16))}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.eval_shape(lambda: JT.init_params(JC.get(arch),
                                                 jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    return jax.tree.map(lambda x: tuple(x.shape), _jax_params(arch))


def _is_spec(x):
    return isinstance(x, P)


def _ways(spec, sizes):
    n = 1
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n *= sizes[a]
    return n


def _bytes(structs, specs, sizes, itemsize=None):
    """The bytes a rank holds of ``structs`` (ShapeDtypeStructs) under
    ``specs``."""
    total = 0
    flat = jax.tree.leaves(structs)
    spec_leaves = jax.tree.leaves(specs, is_leaf=_is_spec)
    assert len(flat) == len(spec_leaves)
    for s, spec in zip(flat, spec_leaves):
        size = itemsize or s.dtype.itemsize
        n = math.prod(s.shape) * size
        ways = _ways(spec, sizes)
        assert n % ways == 0
        total += n // ways
    return total


def _jax_held(arch, shape_name, multi_pod, monkeypatch) -> dict:
    monkeypatch.setattr(JS, "_param_shapes", lambda cfg: _jax_shapes(arch))
    cfg, shape = JC.get(arch), JSHAPES[shape_name]
    sizes = dict(AXES[multi_pod])
    sh = JShard(axis_sizes=AXES[multi_pod])
    pspecs = JS.param_specs(cfg, sh)
    params = _jax_params(arch)
    held = {"params": _bytes(params, pspecs, sizes)}
    if shape.kind == "train":
        zspecs = JS.zero1_specs(pspecs, _jax_shapes(arch), sh)
        held["moments"] = 2 * _bytes(params, zspecs, sizes, itemsize=4)
        held["step"] = 4                      # the int32 step count
        dcfg = JData(vocab=cfg.vocab, seq_len=shape.seq_len,
                     global_batch=shape.global_batch, frontend=cfg.frontend,
                     frame_dim=cfg.frame_dim)
        held["batch"] = _bytes(j_data_specs(dcfg), JS.batch_specs(cfg, sh),
                               sizes)
        return held
    b = shape.global_batch
    bax = sh.batch_axes_for(b)
    if shape.kind == "prefill":
        dims = (b, shape.seq_len) + ((cfg.frame_dim,)
                                     if cfg.frontend == "frames" else ())
        dtype = jnp.float32 if cfg.frontend == "frames" else jnp.int32
        held["inputs"] = _bytes(jax.ShapeDtypeStruct(dims, dtype),
                                P(bax, *(None,) * (len(dims) - 1)), sizes)
        return held
    cache = jax.eval_shape(lambda: JT.init_cache(cfg, b, shape.seq_len))
    held["cache"] = _bytes(cache, JS.cache_specs(cfg, sh, batch=b), sizes)
    vec = jax.ShapeDtypeStruct((b,), jnp.int32)
    held["inputs"] = 2 * _bytes(vec, P(bax), sizes)
    return held


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", TC.ALIASES)
def test_held_bytes_match_jax_spec_arithmetic(arch, multi_pod, monkeypatch):
    """Every shape of the architecture (the step is not run: the held
    bytes are the arguments'); ``long_500k`` skipped where the reference
    skips it."""
    checked = 0
    with D.fake_world(512 if multi_pod else 256):
        sh = D.production_ctx(multi_pod)
        for shape_name in SHAPES:
            run, cell = D.build_cell(arch, shape_name, sh)
            if run is None:
                assert shape_name == "long_500k" and "sub-quadratic" in cell
                continue
            want = _jax_held(arch, shape_name, multi_pod, monkeypatch)
            assert cell["held"] == want, (shape_name, cell["held"], want)
            checked += 1
    assert checked >= 3


# ---------------------------------------------- a dry run against a real run
SMOKE = dict(arch="internlm2-1.8b", seq=16, batch=4, micro=2)


def _smoke_cfg():
    return TC.get_smoke(SMOKE["arch"])


def _real_rank(rank, world):
    """The dry run's training step, run for real on this gloo rank."""
    torch.set_num_threads(1)
    cfg = _smoke_cfg()
    sh = ShardCtx.from_mesh(M.make_dev_mesh(model=2))
    pspecs = TS.param_specs(cfg, sh, TS.needs_fsdp(TC.get(SMOKE["arch"]),
                                                   sh))
    zspecs = TS.zero1_specs(pspecs, TS.param_shapes(cfg), sh)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, "cpu", pspecs, sh)
    opt = init_opt_state(tree_map(
        lambda t: torch.empty_like(t, device="cpu"),
        TS.shard_tree(init_params(cfg, gen, "meta"), zspecs, sh)))
    step = make_train_step(cfg, AdamWConfig(), sh.with_stored(pspecs),
                           micro_batches=SMOKE["micro"], grad_specs=zspecs)
    held = {}
    grads_of = step.compute_grads

    def spied(p, b):
        out = grads_of(p, b)
        held["accumulator"] = D.tree_bytes(out[2])
        return out
    step.compute_grads = spied
    g = torch.Generator().manual_seed(1)
    shape = (SMOKE["batch"], SMOKE["seq"])
    batch = {k: torch.randint(0, cfg.vocab, shape, generator=g,
                              dtype=torch.int32)
             for k in ("inputs", "labels")}
    held.update(params=D.tree_bytes(params),
                moments=D.tree_bytes(opt.mu) + D.tree_bytes(opt.nu))
    sh.traffic.reset()
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as flops, D.CostMode() as cost:
        step(params, opt, batch)
    return {"flops": flops.get_total_flops(),
            "collective": dict(cost.collective),
            "traffic": dict(sh.traffic.bytes), "held": held}


def test_fake_dry_run_equals_a_real_gloo_run(tmp_path):
    real = M.run_ranks(_real_rank, 4, timeout_s=JOIN_S, work_dir=tmp_path)
    with D.fake_world(4):
        sh = D.dev_ctx(2)
        run, cell = D.build_cell(
            SMOKE["arch"], Shape("smoke", "train", SMOKE["seq"],
                                 SMOKE["batch"]), sh, cfg=_smoke_cfg(),
            micro_batches=SMOKE["micro"])
        dry = D.measure(run, cell)
    coll = {k: v for k, v in dry["collective_bytes"].items() if k != "total"}
    for r in real:
        assert r["flops"] == dry["flops"] > 0
        assert r["collective"] == coll
        assert r["traffic"] == dry["traffic"]["bytes"]
        for k in ("params", "moments", "accumulator"):
            assert r["held"][k] == dry["memory"]["held"][k], k
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert dry["memory"]["peak_bytes"] >= dry["memory"]["argument_bytes"]


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_roofline_extrapolation_equals_the_direct_count(kind):
    cfg = _smoke_cfg().with_(n_layers=6)
    shape = Shape("smoke", kind, 32, 4)
    with D.fake_world(4):
        sh = D.dev_ctx(2)
        ext = D.roofline_costs(SMOKE["arch"], shape, sh, cfg=cfg)
        fsdp = TS.needs_fsdp(TC.get(SMOKE["arch"]), sh)
        direct = D._metrics(SMOKE["arch"], shape, sh, cfg, fsdp)
    for k in ("flops", "bytes", "coll"):
        assert ext[k] == direct[k], k
    assert ext["coll_by_op"] == direct["coll_by_op"]
    assert ext["per_layer"]["flops"] > 0
    assert set(ext) == {"flops", "bytes", "coll", "coll_by_op", "per_layer"}


def test_a_running_group_is_refused():
    with D.fake_world(4):
        with pytest.raises(RuntimeError, match="already exists"):
            with D.fake_world(4):
                pass
    assert not torch.distributed.is_initialized()


def test_cli_smoke_cell_subprocess():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internlm2-1.8b", "--shape", "decode_32k"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["flops"] > 0 and rec["collective_bytes"]["total"] > 0
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                  "peak_bytes", "held"}
