"""Sharding context threaded through model code (the port's counterpart of
``repro.models.sharding``).

A ``ShardCtx`` carries a mesh's axis names and sizes and answers "how is
this tensor split here?". With no axes (one device) every query says
"not split". ``ShardCtx.from_mesh`` takes a ``torch.distributed``
``DeviceMesh`` (``launch.mesh.make_dev_mesh``): the model then runs SPMD,
one process a rank, and the context also gives the rank's coordinate on
each axis, each axis's process group and the ``dist.Traffic`` its
collectives count into.

Layout on a mesh (the reference's conventions, as far as they change
values):

* the batch is split over ``("pod", "data")``: every entry point takes
  the rank's own rows (``batch_rows``), and the batch must divide those
  axes;
* the residual stream is replicated over ``"model"``, and so is every
  dense weight where the model computes with it (training stores the
  weights by the reference's specs and gathers each where it is used:
  see below). The reference also places the residual's sequence, the
  attention heads and the FFN's hidden axis on ``"model"``
  (``act_btd``, ``act_bhsd``, ``constrain``): that is placement chosen by
  ``pjit`` and changes no value, so here those stay identities. A
  divergence in placement, not in value;
* the three computations the reference writes across devices are
  explicit here (``dist``): context-parallel attention
  (``layers.attention_seq_sharded``: a rank's query rows, all-gathered),
  the expert-parallel MoE (``moe._moe_expert_parallel``: a rank's tokens,
  its ``E / size("model")`` experts' weights, two all-to-alls), and the
  decode combine over a cache whose sequence axis is split over
  ``"model"`` (``decode.dist_decode``; ``cache_slot`` places a row);
* ``transformer.loss_fn`` is the mean over every rank's tokens, and
  ``transformer.reduce_grads`` turns each rank's gradients into the global loss's.

**Stored layouts** (training over a mesh). A spec is a tuple with one
entry a dimension, the reference's ``PartitionSpec`` entry for entry:
None, an axis name, or a tuple of names (the major axis first); a spec
shorter than its tensor leaves the trailing dimensions whole.
``local_slice`` is a rank's block of a tensor under a spec
(``block_index`` its slices),
``shard_tree`` / ``gather_tree`` a tree's blocks and whole leaves again
(``launch.shardings`` re-exports both), and ``gather`` the all-gather of
one block back to the whole, with a reduce-scatter as its gradient. A
context ``with_stored(specs)`` tells the model that its parameters are
held that way: each layer gathers its leaves where it uses them
(``transformer``'s one rule says which entries), and without stored specs
the parameters are the whole weights (the expert weights of the
expert-parallel MoE the rank's own), as above.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    axis_sizes: tuple = ()       # ((name, size), ...) in mesh order; () = none
    seq_shard: bool = True       # the reference's sequence-parallel placement
    mesh: object = dataclasses.field(default=None, compare=False,
                                     repr=False)       # a DeviceMesh
    traffic: object = dataclasses.field(default=None, compare=False,
                                        repr=False)    # a dist.Traffic
    stored: object = dataclasses.field(default=None, compare=False,
                                       repr=False)     # the params' specs

    @staticmethod
    def from_mesh(mesh, seq_shard: bool = True) -> "ShardCtx":
        """The context of this rank on ``mesh``, a ``DeviceMesh`` with
        named axes."""
        from ..dist import Traffic
        return ShardCtx(tuple(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                        seq_shard=seq_shard, mesh=mesh, traffic=Traffic())

    def with_stored(self, specs) -> "ShardCtx":
        """This context, with the parameters held as ``specs`` (a tree of
        specs in the parameters' structure) say."""
        return dataclasses.replace(self, stored=specs)

    def spec(self, path: tuple) -> tuple:
        """The stored spec of the parameter at ``path`` (keys from the
        root), ``()`` (whole) without stored specs."""
        s = self.stored
        if s is None:
            return ()
        for k in path:
            s = s[k]
        return s

    # --- the reference's queries ---------------------------------------------
    @property
    def names(self) -> tuple:
        return tuple(n for n, _ in self.axis_sizes)

    def size(self, name: str) -> int:
        for n, s in self.axis_sizes:
            if n == name:
                return s
        return 1

    @property
    def batch_axes(self):
        ax = tuple(n for n in ("pod", "data") if n in self.names)
        return ax if ax else None

    def batch_axes_for(self, n: int):
        """The batch axes when a batch of ``n`` rows divides them, else
        None."""
        ax = self.batch_axes
        if ax is None:
            return None
        return ax if n % self.batch_size == 0 else None

    @property
    def model_axis(self):
        return "model" if "model" in self.names else None

    @property
    def all_axes(self):
        return self.names if self.names else None

    def divides(self, n: int, axis: str = "model") -> bool:
        s = self.size(axis)
        return s > 1 and n % s == 0

    def head_axis(self, n_heads: int):
        return self.model_axis if self.divides(n_heads) else None

    # --- placement (identities: see the module docstring) --------------------
    def constrain(self, x, *spec):
        return x

    def act_btd(self, x):
        return x

    def act_bhsd(self, x, n_heads: int):
        return x

    # --- the rank on a mesh -------------------------------------------------
    @property
    def batch_size(self) -> int:
        """How many ways the batch is split (``pod`` x ``data``)."""
        return self.size("pod") * self.size("data")

    @property
    def world(self) -> int:
        n = 1
        for _, s in self.axis_sizes:
            n *= s
        return n

    def coord(self, name: str) -> int:
        """This rank's coordinate on axis ``name`` (0 without a mesh)."""
        if self.mesh is None or name not in self.names:
            return 0
        return self.mesh.get_local_rank(name)

    def group(self, name: str):
        """The process group of this rank's ranks along axis ``name``."""
        if self.mesh is None:
            raise ValueError(f"ShardCtx{self.axis_sizes}: axis {name!r} "
                             "has no process group without a mesh "
                             "(ShardCtx.from_mesh)")
        return self.mesh.get_group(name)

    @property
    def seq_shards(self) -> int:
        """How many ways a decode cache's sequence axis is split: the
        model axis's size on a mesh, else 1."""
        return self.size("model") if self.mesh is not None else 1

    def batch_rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (all of them
        without a mesh)."""
        if self.mesh is None:
            return slice(None)
        dp = self.batch_size
        if n % dp:
            raise ValueError(f"a batch of {n} rows does not divide the "
                             f"batch axes ({dp} ways)")
        i = self.coord("pod") * self.size("data") + self.coord("data")
        return slice(i * (n // dp), (i + 1) * (n // dp))

    def cache_slot(self, pos, size: int):
        """Cache row ``pos`` (global) as an index into this rank's slice of
        ``size`` rows of a sequence-split cache; a row another rank holds
        maps to ``size`` (past the slice: its write is dropped)."""
        if self.seq_shards == 1:
            return pos
        local = pos - self.coord("model") * size
        return local.masked_fill((local < 0) | (local >= size), size)


# --------------------------------------------------------------------------- #
# stored layouts
# --------------------------------------------------------------------------- #

def entry_axes(entry) -> tuple:
    """The axes of one spec entry, the major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple:
    """Every axis a spec names."""
    return tuple(a for e in spec for a in entry_axes(e))


def rank_coords(rank: int, axis_sizes) -> dict:
    """Rank ``rank``'s coordinate on each axis of a mesh of ``axis_sizes``
    (``(name, size)`` pairs in mesh order) that lays the ranks out in row
    major order, as ``init_device_mesh`` does."""
    coords = {}
    for name, size in reversed([tuple(p) for p in axis_sizes]):
        coords[name] = rank % size
        rank //= size
    return coords


def block_index(shape, spec, sh: ShardCtx, coords: dict | None = None
                ) -> tuple:
    """The block of a ``shape`` tensor that ``spec`` gives the rank at
    ``coords`` (by default ``sh``'s own) on ``sh``'s axis sizes: one slice
    a dimension. A dimension that does not divide its axes raises."""
    if coords is None:
        coords = {a: sh.coord(a) for a in sh.names}
    index = [slice(0, n) for n in shape]
    for dim, entry in enumerate(spec):
        n, i = 1, 0
        for a in entry_axes(entry):
            n *= sh.size(a)
            i = i * sh.size(a) + coords.get(a, 0)
        if n == 1:
            continue
        if shape[dim] % n:
            raise ValueError(f"dimension {dim} of a {tuple(shape)} tensor "
                             f"does not split {n} ways ({entry!r})")
        m = shape[dim] // n
        index[dim] = slice(i * m, (i + 1) * m)
    return tuple(index)


def local_slice(t: torch.Tensor, spec, sh: ShardCtx,
                coords: dict | None = None) -> torch.Tensor:
    """The block of ``t`` that ``spec`` gives the rank at ``coords`` (by
    default ``sh``'s own): a view (``block_index``)."""
    return t[block_index(t.shape, spec, sh, coords)]


def gather(t: torch.Tensor, spec, sh: ShardCtx) -> torch.Tensor:
    """The whole tensor from each rank's block under ``spec``: all-gathered
    over each axis of each entry, the minor axis first (with its gradient,
    a reduce-scatter back to the block)."""
    from .. import dist
    for dim, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            t = dist.all_gather(t, dim, sh, a)
    return t


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree (dicts, NamedTuples, tuples, lists)
    and its specs, which follow the tree's structure down to its
    leaves."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v, s)
                            for v, s in zip(tree, specs)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_specs(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def shard_tree(tree, specs, sh: ShardCtx):
    """This rank's block of every leaf of ``tree`` under ``specs``, copied
    so that the whole can be freed; a leaf that no axis splits is returned
    as it is."""
    def one(t, spec):
        block = local_slice(t, spec, sh)
        if block.shape == t.shape:
            return t
        return block.clone(memory_format=torch.contiguous_format)
    return map_specs(one, tree, specs)


@torch.no_grad()
def gather_tree(tree, specs, sh: ShardCtx):
    """Every leaf of ``tree``, held as ``specs`` say, whole again (on every
    rank)."""
    return map_specs(lambda t, spec: gather(t, spec, sh), tree, specs)
