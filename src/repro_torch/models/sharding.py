"""Sharding context threaded through model code (the port's counterpart of
``repro.models.sharding``), for one device.

The reference's ``ShardCtx`` carries a mesh's axis names and sizes and
turns every activation constraint into a ``with_sharding_constraint``.
The port runs the model on one device, so every constraint is the
identity. A context with axes raises: the multi-card path
(``torch.distributed``) waits for ROADMAP §1 item 1.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    axis_sizes: tuple = ()       # must stay (): one device
    seq_shard: bool = True

    def __post_init__(self):
        if self.axis_sizes:
            raise NotImplementedError(
                f"ShardCtx(axis_sizes={self.axis_sizes!r}): the port runs "
                "the model on one device; the multi-card path waits for "
                "ROADMAP §1 item 1")

    def constrain(self, x, *spec):
        return x

    def act_btd(self, x):
        return x

    def act_bhsd(self, x, n_heads: int):
        return x
