"""Multi-pod dry run (the port of ``repro.launch.dryrun``): run every
(architecture x input shape) cell's step once as one rank of the
production meshes, and report what that rank computes, moves and holds.

The reference lowers and compiles each cell with XLA over 512 host
devices. Here one process joins a ``torch.distributed`` ``"fake"``
process group (``torch.testing._internal.distributed.fake_pg``) of 256
ranks (16 x 16, ``("data", "model")``) or 512 (2 x 16 x 16, ``("pod",
"data", "model")``) as rank 0: the group stands in for the reference's
512 host devices. The mesh is ``launch.mesh.make_production_mesh``, the
step the port's own ``launch.steps.make_train_step`` /
``make_prefill_step`` / ``make_serve_step``, and every tensor lives on the
``meta`` device: the rank's blocks are empty ``meta`` tensors cut by
``launch.shardings``' specs from ``param_shapes``, so nothing is
allocated at model scale and nothing is drawn. The fake group's
collectives return empty results of the right shapes; the values are
never read.

Each field is defined anew, since there is no XLA to ask:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count on the
  rank (products and attention; the backward and its recompute
  included).
* ``bytes``: every dispatched ATen op's operand and result bytes,
  unfused, views left out (a ``TorchDispatchMode``). An upper bound, not
  XLA's ``bytes accessed``.
* ``collective_bytes``: the result bytes on the rank of every functional
  collective, by the reference's op names, plus ``total`` (the
  reference's definition, ``collective_bytes``); ``traffic`` beside it
  is ``dist.Traffic``'s count of the operands' bytes by collective.
* ``memory``: ``argument_bytes`` (what the rank holds on entry: its
  weight blocks, moments and its rows of the batch, or its cache),
  ``output_bytes`` (the result's distinct storages), ``peak_bytes`` (the
  largest sum of live storages during the step, the arguments included,
  tracked by the same dispatch mode with a weak reference on every
  storage it sees created) and ``held``, the arguments by kind.
* ``trace_s``: the step's wall time on the host.

``--roofline`` adds ``roofline_raw`` with the reference's keys for
``benchmarks/roofline.py``: the port counts every layer, so ``per_layer``
is the count at 2 layers less the count at 1; the totals are extrapolated
from the counts at 1-4 layers (``roofline_costs``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod |
        --both-meshes] [--roofline] [--out results/dryrun.jsonl]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .. import configs
from ..configs.shapes import SHAPES, Shape, shape_applicable
from ..data import DataConfig, batch_specs as data_specs
from ..models import ModelConfig, ShardCtx, init_cache, init_params
from ..models.sharding import block_index, map_specs
from ..optim import AdamWConfig, OptState
from . import shardings as shd
from .mesh import make_dev_mesh, make_production_mesh
from .steps import make_prefill_step, make_serve_step, make_train_step

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# the functional collectives' ops (``torch.ops._c10d_functional``) under
# the reference's names; the port makes no collective-permute
_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}

MESHES = {False: "16x16", True: "2x16x16"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """Every tensor of a tree (dicts, tuples, NamedTuples), in order."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def tree_bytes(tree) -> int:
    return sum(map(_nbytes, _tensors(tree)))


def micro_batches_for(arch: str, shape_name: str) -> int:
    """Gradient-accumulation depth per cell (activation-memory lever)."""
    if shape_name != "train_4k":
        return 1
    return {"deepseek-v2-236b": 8, "phi3.5-moe-42b-a6.6b": 4,
            "minitron-8b": 2, "rwkv6-7b": 2}.get(arch, 1)


class CostMode(TorchDispatchMode):
    """Counts, over every ATen op dispatched inside it: ``bytes`` (operands
    and results, views left out), ``collective`` (each functional
    collective's result bytes under the reference's name) and the live
    bytes of the storages the ops create (``live``, ``peak``). A storage
    is counted once, when an op first returns it, and dropped when it is
    freed (a weak reference's finaliser); ``hold`` counts one made before
    (an argument) at the bytes given."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collective = dict.fromkeys(_COLLECTIVES, 0)
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakSet()

    def _free(self, n: int) -> None:
        self.live -= n

    def _count(self, st, n: int, finalise: bool) -> None:
        if st in self._seen:
            return
        self._seen.add(st)
        self.live += n
        if finalise:
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)

    def hold(self, t: torch.Tensor, n: int | None = None) -> None:
        self._count(t.untyped_storage(), _nbytes(t) if n is None else n,
                    False)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if func.namespace == "_c10d_functional":
            name = _FUNCTIONAL.get(func._opname)
            if name:
                self.collective[name] += sum(map(_nbytes, outs))
        if not func.is_view:
            self.bytes += tree_bytes((args, kwargs)) + \
                sum(map(_nbytes, outs))
        for t in outs:
            st = t.untyped_storage()
            self._count(st, st.nbytes(), True)
        return out


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a ``"fake"`` process group of ``world``
    ranks, destroyed on exit. Refuses to start where a group exists."""
    if dist.is_initialized():
        raise RuntimeError(
            "dryrun: a process group already exists; the dry run joins a "
            "fake group of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_ctx(multi_pod: bool) -> ShardCtx:
    """Rank 0's context on the production mesh (inside ``fake_world`` of
    its size)."""
    return ShardCtx.from_mesh(make_production_mesh(multi_pod=multi_pod,
                                                   device_type="cpu"))


def dev_ctx(model: int) -> ShardCtx:
    """Rank 0's context on ``make_dev_mesh(model)`` over the running
    group."""
    return ShardCtx.from_mesh(make_dev_mesh(model=model, device_type="cpu"))


def _meta_params(cfg: ModelConfig) -> dict:
    """Every parameter as an empty ``meta`` tensor of its shape
    (``shardings.param_shapes``'s build) and dtype: no memory, no
    draws."""
    return init_params(cfg, torch.Generator(), device="meta")


def _blocks(meta: dict, specs, sh: ShardCtx, dtype=None):
    """The rank's block of every leaf of ``meta`` under ``specs``, empty
    on ``meta``, in ``dtype`` (default the leaf's)."""
    def one(t, spec):
        index = block_index(t.shape, spec, sh)
        return torch.empty(tuple(i.stop - i.start for i in index),
                           dtype=dtype or t.dtype, device="meta")
    return map_specs(one, meta, specs)


def _spec_bytes(t: torch.Tensor, spec, sh: ShardCtx) -> int:
    index = block_index(t.shape, spec, sh)
    n = 1
    for i in index:
        n *= i.stop - i.start
    return n * t.element_size()


def build_cell(arch: str, shape: Shape | str, sh: ShardCtx,
               cfg: ModelConfig | None = None,
               micro_batches: int | None = None, fsdp: bool | None = None):
    """(run, cell) for one (arch x shape) cell on ``sh``'s mesh, or
    (None, reason) where the shape does not apply. ``shape`` is a name of
    ``SHAPES`` or a ``Shape``; ``cfg`` defaults to the architecture's
    configuration. ``run()`` calls the step once on the rank's ``meta``
    blocks and returns its result; ``cell`` holds the arguments
    (``args``: each tensor with the bytes the rank holds of it), ``held``
    (bytes by kind), and, for training, ``grads``, which ``run`` fills
    with the accumulated gradients' bytes. ``fsdp`` defaults to
    ``needs_fsdp`` of the named architecture's full configuration (a
    depth cut keeps its deployment's layout)."""
    base = configs.get(arch)
    cfg = cfg or base
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, why
    if fsdp is None:
        fsdp = shd.needs_fsdp(base, sh)
    meta = _meta_params(cfg)
    pspecs = shd.param_specs(cfg, sh, fsdp)
    params = _blocks(meta, pspecs, sh)
    ssh = sh.with_stored(pspecs)
    args = [(t, None) for t in _tensors(params)]
    held = {"params": tree_bytes(params)}
    cell = {"args": args, "held": held, "sh": ssh}

    if shape.kind == "train":
        zspecs = shd.zero1_specs(pspecs, shd.param_shapes(cfg), sh)
        # the step count on the host: the update reads it as an int
        opt = OptState(mu=_blocks(meta, zspecs, sh, torch.float32),
                       nu=_blocks(meta, zspecs, sh, torch.float32),
                       step=torch.zeros((), dtype=torch.int32))
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                          global_batch=shape.global_batch,
                          frontend=cfg.frontend, frame_dim=cfg.frame_dim)
        # the global batch (the step takes the rank's rows of it), held
        # as its block under batch_specs
        batch = data_specs(dcfg)
        bspecs = shd.batch_specs(cfg, sh)
        held["moments"] = tree_bytes(opt.mu) + tree_bytes(opt.nu)
        held["step"] = _nbytes(opt.step)
        held["batch"] = sum(_spec_bytes(batch[k], bspecs[k], sh)
                            for k in batch)
        args += [(t, None) for t in _tensors(opt)]
        args += [(batch[k], _spec_bytes(batch[k], bspecs[k], sh))
                 for k in batch]
        mb = (micro_batches if micro_batches is not None
              else micro_batches_for(arch, shape.name))
        step = make_train_step(cfg, AdamWConfig(), ssh, micro_batches=mb,
                               grad_specs=zspecs)
        grads_of = step.compute_grads

        def compute_grads(p, b):
            out = grads_of(p, b)
            cell["grads"] = tree_bytes(out[2])
            return out
        step.compute_grads = compute_grads
        return (lambda: step(params, opt, batch)), cell

    # serving: the rank's own rows (all of them where the batch does not
    # divide the batch axes: the reference's unsharded batch)
    rows = shape.global_batch
    if sh.batch_axes_for(rows) is not None:
        rows //= sh.batch_size
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, ssh, smax=shape.seq_len)
        if cfg.frontend == "frames":
            inputs = torch.empty((rows, shape.seq_len, cfg.frame_dim),
                                 dtype=torch.float32, device="meta")
        else:
            inputs = torch.empty((rows, shape.seq_len), dtype=torch.int32,
                                 device="meta")
        held["inputs"] = _nbytes(inputs)
        args.append((inputs, None))
        return (lambda: step(params, inputs)), cell

    step = make_serve_step(cfg, ssh)
    cache = init_cache(cfg, rows, shape.seq_len, device="meta", sh=ssh)
    tokens = torch.empty((rows,), dtype=torch.int32, device="meta")
    pos = torch.empty((rows,), dtype=torch.int32, device="meta")
    held["cache"] = tree_bytes(cache)
    held["inputs"] = _nbytes(tokens) + _nbytes(pos)
    args += [(t, None) for t in _tensors(cache)]
    args += [(tokens, None), (pos, None)]
    return (lambda: step(params, tokens, cache, pos)), cell


def measure(run, cell) -> dict:
    """Run one built cell under the counters; its fields (see the module
    docstring)."""
    sh = cell["sh"]
    sh.traffic.reset()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, CostMode() as cost:
        for t, n in cell["args"]:
            cost.hold(t, n)
        out = run()
    trace_s = time.perf_counter() - t0
    seen, out_bytes = set(), 0
    for t in _tensors(out):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            out_bytes += st.nbytes()
    coll = dict(cost.collective)
    coll["total"] = sum(coll[k] for k in _COLLECTIVES)
    held = dict(cell["held"])
    if "grads" in cell:
        held["accumulator"] = cell["grads"]
    return {"trace_s": round(trace_s, 3),
            "flops": float(flops.get_total_flops()),
            "bytes": float(cost.bytes), "collective_bytes": coll,
            "traffic": {k: dict(v) for k, v in sh.traffic.as_dict().items()
                        if k in ("bytes", "calls")},
            "memory": {"argument_bytes": sum(cell["held"].values()),
                       "output_bytes": out_bytes,
                       "peak_bytes": cost.peak, "held": held}}


def _metrics(arch, shape, sh, cfg, fsdp) -> dict | None:
    run, cell = build_cell(arch, shape, sh, cfg=cfg, micro_batches=1,
                           fsdp=fsdp)
    if run is None:
        return None
    m = measure(run, cell)
    return {"flops": m["flops"], "bytes": m["bytes"],
            "coll": m["collective_bytes"]["total"],
            "coll_by_op": m["collective_bytes"]}


def _at_depth(v: list, L: int):
    """A count at ``L`` layers from the counts ``v`` at 1 to 4 layers:
    ``v[L - 1]`` where measured, else quadratic in L through the counts at
    2, 3 and 4 (linear where the second difference is 0)."""
    if L <= len(v):
        return v[L - 1]
    v2, v3, v4 = v[1:4]
    return v2 + (L - 2) * (v3 - v2) + (L - 2) * (L - 3) // 2 * (
        v4 - 2 * v3 + v2)


def roofline_costs(arch: str, shape: Shape | str, mesh,
                   cfg: ModelConfig | None = None) -> dict:
    """Per-rank FLOPs / bytes / collective totals at ``cfg``'s depth
    (default the architecture's configuration), one micro-batch, the full
    configuration's FSDP choice, extrapolated from the counts at 1-4
    layers; ``per_layer`` is the count at 2 layers less the count at 1,
    as the reference reports it. The reference's extrapolation is linear,
    (2 V1 - V2) + L (V2 - V1). The port's training bytes are not: each
    layer's backward writes a gradient of the whole layer-stacked weights
    (the backward of the layer's view), so they grow as L^2 past the
    first layer, and the totals are quadratic in L through the counts at
    2, 3 and 4 layers (the FLOPs and collectives, linear, come out as the
    reference's formula gives them). ``mesh``: a ``DeviceMesh`` or this
    rank's ``ShardCtx`` on one."""
    sh = mesh if isinstance(mesh, ShardCtx) else ShardCtx.from_mesh(mesh)
    cfg = cfg or configs.get(arch)
    fsdp = shd.needs_fsdp(configs.get(arch), sh)
    vs = []
    for lvar in (1, 2, 3, 4):
        v = _metrics(arch, shape, sh, cfg.with_(n_layers=lvar), fsdp)
        if v is None:
            shape = SHAPES[shape] if isinstance(shape, str) else shape
            return {"status": "skipped",
                    "reason": shape_applicable(cfg, shape)[1]}
        vs.append(v)
    L = cfg.n_layers
    out = {k: float(_at_depth([v[k] for v in vs], L))
           for k in ("flops", "bytes", "coll")}
    out["coll_by_op"] = {k: _at_depth([v["coll_by_op"][k] for v in vs], L)
                         for k in vs[0]["coll_by_op"]}
    out["per_layer"] = {k: vs[1][k] - vs[0][k]
                        for k in ("flops", "bytes", "coll")}
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             roofline: bool = False) -> dict:
    """One cell on a production mesh, in a fake group of its own."""
    rec = {"arch": arch, "shape": shape_name, "mesh": MESHES[multi_pod]}
    with fake_world(512 if multi_pod else 256):
        sh = production_ctx(multi_pod)
        run, cell = build_cell(arch, shape_name, sh)
        if run is None:
            rec.update(status="skipped", reason=cell)
            return rec
        rec.update(status="ok", **measure(run, cell))
        del run, cell
        if roofline:
            rec["roofline_raw"] = roofline_costs(arch, shape_name, sh)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="also extract the roofline costs (slower)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in configs.ALIASES for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    out = open(args.out, "a") if args.out else None
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            try:
                rec = run_cell(arch, shape, mp, roofline=args.roofline)
            except Exception as e:           # a failure here is a system bug
                rec = {"arch": arch, "shape": shape, "mesh": MESHES[mp],
                       "status": "FAILED", "error": repr(e)[:500]}
                failures += 1
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
