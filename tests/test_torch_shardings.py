"""The port's weight, moment, batch and cache specs against the JAX
package's, on the CPU (no ranks: the spec functions need no device).

``launch.shardings.param_specs`` / ``zero1_specs`` / ``needs_fsdp`` /
``batch_specs`` / ``cache_specs`` of ``repro_torch`` against
``repro.launch.shardings``, entry for entry, for all ten configurations
at full size, on (data 2, model 2), (data 16, model 16) and (pod 2, data
16, model 16), with ``fsdp`` None, True and False. A ``PartitionSpec``
writes a one-axis tuple entry as the axis's name; the port's specs do
too. The shapes are the port's ``init_params`` on the ``meta`` device,
held to JAX's ``jax.eval_shape`` of its own; the slicing helpers
(``local_slice``, ``rank_coords``) are held to the layouts those specs
name.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as JC
from repro.launch import shardings as JS
from repro.models import ShardCtx as JShard

import repro_torch.configs as TC
from repro_torch.launch import shardings as TS
from repro_torch.models import ShardCtx, init_params
from repro_torch.models import sharding as TSh
from test_torch_models import leaves

MESHES = {
    "2x2": (("data", 2), ("model", 2)),
    "16x16": (("data", 16), ("model", 16)),
    "pod": (("pod", 2), ("data", 16), ("model", 16)),
}


_EVAL_SHAPES = JS._param_shapes


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    return _EVAL_SHAPES(JC.get(arch))


def _entry(e):
    """A JAX spec entry as the port writes it."""
    if isinstance(e, tuple) and len(e) == 1:
        return e[0]
    return e


def _as_port(tree):
    return jax.tree.map(lambda s: tuple(_entry(e) for e in s), tree,
                        is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("fsdp", [None, True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", TC.ARCHS)
def test_specs_match_jax(arch, mesh, fsdp, monkeypatch):
    # the reference's shapes are jax.eval_shape of its init: cached here
    monkeypatch.setattr(JS, "_param_shapes",
                        lambda cfg: _jax_shapes(arch))
    jcfg, tcfg = JC.get(arch), TC.get(arch)
    jsh, tsh = JShard(axis_sizes=MESHES[mesh]), \
        ShardCtx(axis_sizes=MESHES[mesh])
    shapes = TS.param_shapes(tcfg)
    assert shapes == _jax_shapes(arch)
    assert TS.needs_fsdp(tcfg, tsh) == JS.needs_fsdp(jcfg, jsh)

    jp = JS.param_specs(jcfg, jsh, fsdp)
    tp = TS.param_specs(tcfg, tsh, fsdp)
    assert tp == _as_port(jp)
    jz = JS.zero1_specs(jp, _jax_shapes(arch), jsh)
    assert TS.zero1_specs(tp, shapes, tsh) == _as_port(jz)
    assert TS.batch_specs(tcfg, tsh) == _as_port(JS.batch_specs(jcfg, jsh))
    for batch in (None, 1, 32, 64):
        want = _as_port(JS.cache_specs(jcfg, jsh, batch))
        got = TS.cache_specs(tcfg, tsh, batch)
        assert got == (tuple(want) if isinstance(want, list) else want)

    # every spec names axes of the mesh and tiles its leaf evenly
    sizes = dict(MESHES[mesh])
    for spec, shape in zip(jax.tree.leaves(
            TS.zero1_specs(tp, shapes, tsh), is_leaf=lambda x: isinstance(
                x, tuple) and all(not isinstance(e, dict) for e in x)),
            jax.tree.leaves(shapes, is_leaf=lambda x: isinstance(x, tuple))):
        assert len(spec) <= len(shape)
        for e, n in zip(spec, shape):
            ways = int(np.prod([sizes[a] for a in TSh.entry_axes(e)]))
            assert n % ways == 0, (spec, shape)


def test_depth_cut_config_does_not_choose_fsdp():
    """``needs_fsdp`` reads the configuration as given: deepseek-v2 at full
    depth needs FSDP on a 16-way model axis, 2 of its 60 layers do not."""
    sh = ShardCtx(axis_sizes=MESHES["16x16"])
    cfg = TC.get("deepseek-v2-236b")
    assert TS.needs_fsdp(cfg, sh)
    assert not TS.needs_fsdp(cfg.with_(n_layers=2), sh)
    specs = TS.param_specs(cfg, sh)
    assert specs["embed"]["tokens"] == ("model", "data")
    assert "data" not in TS.param_specs(cfg.with_(n_layers=2), sh)[
        "embed"]["tokens"]


class _AtCoords(ShardCtx):
    """A context without a mesh that reports given coordinates."""

    def __init__(self, axis_sizes, coords):
        super().__init__(axis_sizes)
        object.__setattr__(self, "_coords", coords)

    def coord(self, name):
        return self._coords.get(name, 0)


@pytest.mark.parametrize("spec", [("data", None), (None, "model"),
                                  ("model", "data"), (("pod", "data"),),
                                  (None, ("data", "model"))])
def test_blocks_tile_the_tensor(spec):
    """Every rank's ``local_slice`` under a spec, placed by its coordinates
    (``rank_coords``: row major, as ``init_device_mesh``), tiles the
    tensor: every element is held by the same number of ranks, the
    product of the sizes of the axes the spec leaves out; a dimension
    that does not divide raises."""
    axes = (("pod", 2), ("data", 2), ("model", 2))
    t = torch.arange(8 * 12).reshape(8, 12)
    seen = torch.zeros_like(t)
    for rank in range(8):
        coords = TSh.rank_coords(rank, axes)
        assert rank == (coords["pod"] * 2 + coords["data"]) * 2 + \
            coords["model"]
        block = TSh.local_slice(t, spec, _AtCoords(axes, coords))
        rows = {a for e in spec for a in TSh.entry_axes(e)}
        copies = 2 ** (3 - len(rows))
        seen.view(-1)[block.reshape(-1)] += 1
        assert block.numel() == t.numel() // 2 ** len(rows)
    assert torch.equal(seen, torch.full_like(t, copies))
    with pytest.raises(ValueError, match="does not split"):
        TSh.local_slice(torch.zeros(3, 4), ("data",),
                        _AtCoords(axes, {"data": 1}))


@pytest.mark.parametrize("arch,fsdp", [("internlm2_1p8b", False),
                                       ("hymba_1p5b", False),
                                       ("rwkv6_7b", False),
                                       ("deepseek_v2_236b", True),
                                       ("phi35_moe_42b", True),
                                       ("musicgen_medium", False)])
def test_blocks_drawn_alone_are_the_blocks_of_the_whole(arch, fsdp):
    """``init_params`` with specs draws a rank's blocks alone: on every
    rank of (data 2, model 2) they equal, bit for bit, that rank's blocks
    of the whole model from the same seed (Hymba's attention ``wo``,
    drawn and dropped, included), and no leaf is larger than its
    block."""
    cfg = TC.get_smoke(arch)
    axes = MESHES["2x2"]
    specs = TS.param_specs(cfg, _AtCoords(axes, {}), fsdp)
    whole = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for rank in range(4):
        sh = _AtCoords(axes, TSh.rank_coords(rank, axes))
        got = init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                          specs, sh)
        want = TS.shard_tree(whole, specs, sh)
        for (path, g), (_, w) in zip(leaves(got), leaves(want)):
            assert g.dtype == w.dtype and torch.equal(g, w), (rank, path)
            assert g.is_contiguous(), (rank, path)
