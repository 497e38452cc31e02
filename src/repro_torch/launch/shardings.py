"""Specs for every tree the port splits over a mesh (the port of
``repro.launch.shardings``).

A spec is a tuple with one entry a dimension, the reference's
``PartitionSpec`` entry for entry: None, an axis name, or a tuple of
names (``models.sharding``). The rules are the reference's: weights are
stacked over layers (their specs lead with None); heads and hidden axes
go on ``"model"`` only where ``ShardCtx.divides`` holds (gemma3's 8 and
hymba's 25 heads stay whole); the ZeRO-1 moment specs split one more
dimension over ``"data"``; ``needs_fsdp`` splits the weights themselves
over ``"data"`` too where a model-axis replica passes the budget.

``shard_tree`` / ``gather_tree`` (from ``models.sharding``) take a
tree to this rank's blocks and back to whole leaves: the counterpart of
the reference's ``to_named``, which hands the layout to ``pjit``. The
shapes come from the port's ``init_params`` on the ``meta`` device.
"""
from __future__ import annotations

import functools

import torch

from ..models import ModelConfig, ShardCtx, init_params
from ..models.sharding import gather_tree, shard_tree
from ..tree import tree_map

__all__ = ["param_specs", "zero1_specs", "needs_fsdp", "batch_specs",
           "cache_specs", "param_shapes", "shard_tree", "gather_tree"]


def _attn_specs(cfg: ModelConfig, sh: ShardCtx) -> dict:
    m = sh.model_axis
    heads_ok = sh.divides(cfg.n_heads * cfg.head_dim_) and \
        sh.divides(cfg.n_heads)
    kv_ok = sh.divides(cfg.n_kv_heads * cfg.head_dim_) and \
        sh.divides(cfg.n_kv_heads)
    h = m if heads_ok else None
    k = m if kv_ok else None
    if cfg.attn_type in ("gqa", "hymba"):
        base = {"norm": (), "wq": (None, None, h), "wk": (None, None, k),
                "wv": (None, None, k)}
        if cfg.attn_type == "gqa":
            base["wo"] = (None, h, None)
            return base
        dm = m if sh.divides(cfg.n_heads * cfg.head_dim_) else None
        base.update({
            "wo": (None, dm, None),
            "attn_out_norm": (), "ssm_out_norm": (),
            "mamba": {
                "in_proj": (None, None, dm),
                "conv_w": (None, dm, None),
                "x_proj": (None, dm, None),
                "dt_proj": (None, None, dm),
                "dt_bias": (None, dm),
                "a_log": (None, dm, None),
                "d_skip": (None, dm),
            },
        })
        return base
    if cfg.attn_type == "mla":
        h = m if sh.divides(cfg.n_heads) else None
        return {"norm": (), "wq_a": (None, None, None), "q_norm": (),
                "wq_b": (None, None, h),
                "wkv_a": (None, None, None), "kv_norm": (),
                "wk_b": (None, None, h), "wv_b": (None, None, h),
                "wo": (None, h, None)}
    if cfg.attn_type == "rwkv6":
        h = m if sh.divides(cfg.d_model) and sh.divides(cfg.n_heads) \
            else None
        return {"norm": (), "mu_r": (), "mu_k": (), "mu_v": (), "mu_w": (),
                "mu_g": (),
                "w_r": (None, None, h), "w_k": (None, None, h),
                "w_v": (None, None, h), "w_g": (None, None, h),
                "w_o": (None, h, None),
                "decay_a": (), "decay_b": (None, None, h),
                "decay_base": (None, h) if h else (),
                "u": (None, h, None), "gn_w": (None, h) if h else ()}
    raise ValueError(cfg.attn_type)


def _mlp_specs(cfg: ModelConfig, sh: ShardCtx) -> dict:
    m = sh.model_axis
    if cfg.attn_type == "rwkv6":
        f = m if sh.divides(cfg.d_ff) else None
        return {"norm": (), "mu_k": (), "mu_r": (),
                "w_k": (None, None, f), "w_v": (None, f, None),
                "w_r": (None, None, None)}
    if cfg.moe:
        e = m if sh.divides(cfg.moe.n_experts) else None
        p = {"norm": (), "router": (None, None, None),
             "w_in": (None, e, None, None), "w_gate": (None, e, None, None),
             "w_out": (None, e, None, None)}
        if cfg.moe.n_shared:
            f = m if sh.divides(cfg.moe.d_ff_shared) else None
            p["shared"] = {"w_in": (None, None, f), "w_gate": (None, None, f),
                           "w_out": (None, f, None)}
        return p
    f = m if sh.divides(cfg.d_ff) else None
    return {"norm": (), "w_in": (None, None, f), "w_gate": (None, None, f),
            "w_out": (None, f, None)}


def needs_fsdp(cfg: ModelConfig, sh: ShardCtx,
               hbm_budget: float = 8e9) -> bool:
    """Whether a model-axis replica of the bf16 weights passes
    ``hbm_budget`` (deepseek-v2: 29.5 GB on a 16-way model axis), so that
    the weights are split over ``"data"`` too (FSDP). Reads
    ``cfg.n_params()`` of the configuration as given: a depth-cut
    configuration does not choose FSDP by itself."""
    msz = max(1, sh.size("model"))
    return cfg.n_params() * 2 / msz > hbm_budget


def param_specs(cfg: ModelConfig, sh: ShardCtx,
                fsdp: bool | None = None) -> dict:
    """The weights' specs (``fsdp`` None: ``needs_fsdp``)."""
    m = sh.model_axis
    v = m if sh.divides(cfg.vocab) else None
    embed = {"tokens": (v, None)}
    if cfg.frontend == "frames":
        embed["frames"] = (None, None)
    specs = {"embed": embed,
             "layers": {"attn": _attn_specs(cfg, sh),
                        "mlp": _mlp_specs(cfg, sh)},
             "final_norm": ()}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, v)
    if fsdp is None:
        fsdp = needs_fsdp(cfg, sh)
    if fsdp and "data" in sh.names:
        specs = zero1_specs(specs, param_shapes(cfg), sh)
    return specs


@functools.lru_cache(maxsize=32)
def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape, from ``init_params`` on the ``meta``
    device (no memory, no draws)."""
    params = init_params(cfg, torch.Generator(), device="meta")
    return tree_map(lambda t: tuple(t.shape), params)


def zero1_specs(param_specs_tree, params_shapes, sh: ShardCtx):
    """The optimizer moments' specs (ZeRO-1): each parameter's spec with
    its largest unsharded dimension that ``"data"`` divides split over
    ``"data"`` (the first of equal dimensions); a spec already split over
    ``"data"`` (FSDP) and a scalar stay as they are. Entries are padded
    with None to the tensor's rank."""
    if "data" not in sh.names:
        return param_specs_tree
    dsz = sh.size("data")

    def one(spec, shape):
        if len(shape) == 0:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if any(e == "data" or (isinstance(e, tuple) and "data" in e)
               for e in entries):
            return tuple(entries)
        best, best_dim = None, 0
        for i, (e, dim) in enumerate(zip(entries, shape)):
            if e is None and dim % dsz == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best is not None:
            entries[best] = "data"
        return tuple(entries)

    return tree_map(one, param_specs_tree, params_shapes)


def _axes_entry(axes):
    """A tuple of axes as one spec entry: a single axis by its name, as
    ``PartitionSpec`` writes it."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def batch_specs(cfg: ModelConfig, sh: ShardCtx) -> dict:
    b = _axes_entry(sh.batch_axes)
    if cfg.frontend == "frames":
        return {"inputs": (b, None, None), "labels": (b, None)}
    return {"inputs": (b, None), "labels": (b, None)}


def cache_specs(cfg: ModelConfig, sh: ShardCtx,
                batch: int | None = None):
    """Decode-cache specs: the batch over the batch axes (where it divides
    them), the sequence over ``"model"``."""
    b = _axes_entry(sh.batch_axes if batch is None
                    else sh.batch_axes_for(batch))
    m = sh.model_axis
    if cfg.attn_type == "gqa":
        kv = (None, b, None, m, None)
        return {"k": kv, "v": kv}
    if cfg.attn_type == "mla":
        return {"c_kv": (None, b, m, None), "k_rope": (None, b, m, None)}
    if cfg.attn_type == "rwkv6":
        h = m if sh.divides(cfg.n_heads) else None
        return {"state": (None, b, h, None, None),
                "prev_att": (None, b, None), "prev_ffn": (None, b, None)}
    if cfg.attn_type == "hymba":
        di = m if sh.divides(cfg.n_heads * cfg.head_dim_) else None
        kv = (b, None, m, None)
        return tuple({"k": kv, "v": kv, "conv": (b, None, di),
                      "ssm": (b, di, None)}
                     for _ in range(cfg.n_layers))
    raise ValueError(cfg.attn_type)
