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
* the residual stream and the dense weights are replicated over
  ``"model"``. The reference also places the residual's sequence, the
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
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    axis_sizes: tuple = ()       # ((name, size), ...) in mesh order; () = none
    seq_shard: bool = True       # the reference's sequence-parallel placement
    mesh: object = dataclasses.field(default=None, compare=False,
                                     repr=False)       # a DeviceMesh
    traffic: object = dataclasses.field(default=None, compare=False,
                                        repr=False)    # a dist.Traffic

    @staticmethod
    def from_mesh(mesh, seq_shard: bool = True) -> "ShardCtx":
        """The context of this rank on ``mesh``, a ``DeviceMesh`` with
        named axes."""
        from ..dist import Traffic
        return ShardCtx(tuple(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                        seq_shard=seq_shard, mesh=mesh, traffic=Traffic())

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
