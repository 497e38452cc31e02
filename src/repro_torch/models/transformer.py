"""Model assembly for every family: init, the full-sequence forward,
prefill and decode (the port's counterpart of
``repro.models.transformer``).

The block families are dense GQA (``layers``), MLA (``mla``), RWKV6
(``rwkv``) and Hymba's parallel attention + Mamba (``mamba``); the FFN is
a SwiGLU, RWKV's channel mix, or a mixture of experts (``moe``).
Parameters are stacked over layers (``[L, ...]``, the reference's scan
layout) and the layer scan is a Python loop over that axis. Per-layer
heterogeneity (gemma3's 5:1 local:global interleave, Hymba's global
layers) rides through ``layer_windows``: one ``Optional[int]`` a layer,
None for a global layer (the reference's ``NO_WINDOW`` sentinel).

Cache convention: ``pos`` = number of tokens already in the cache. A
decode step writes the new token's state at index ``pos`` and attends
over ``pos + 1`` entries. The caches are stacked over layers
(``{"k", "v"}``, ``{"c_kv", "k_rope"}``, ``{"state", "prev_att",
"prev_ffn"}``), except Hymba's: a tuple of per-layer dicts, whose local
layers hold ring buffers of the window (``hymba_cache_sizes``). The port
updates the cache in place and returns it. A lane whose ``pos`` has
passed the cache's capacity (an idle serving lane, which every step
still advances) has its write dropped, as the reference's out-of-range
scatter is, with no device assert and no host synchronisation; a Hymba
ring wraps instead, as in the reference.

Training: ``loss_fn`` is next-token cross-entropy plus the MoE's load
balance. With autograd recording, ``forward_seq`` recomputes each layer
in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` over its layer scan), so only the layers' inputs are
kept; prefill and serving run as before.

On a mesh (``ShardCtx.from_mesh``; see ``sharding`` for the layout) every
entry point takes the rank's batch rows; ``shard_params`` keeps a rank's
experts; ``init_cache`` and ``prefill`` build the rank's slice of a cache
split on its sequence axis over ``"model"``, which ``decode_step`` writes
only where the rank holds the row, and the rank's block of RWKV's and
Mamba's recurrent states where ``launch.shardings.cache_specs`` splits
them over ``"model"`` (``decode_step`` gathers a layer's state whole,
steps it and keeps the rank's block); ``loss_fn`` is the mean over every
rank's tokens, and ``reduce_grads`` makes each rank's gradients those of
that global loss.

Training over a mesh stores the parameters by the reference's specs
(``ShardCtx.with_stored``, ``launch.shardings.param_specs``): each layer
all-gathers its leaves inside ``_seq_block`` (so inside the checkpointed
``_train_block``: the backward's recompute gathers again, and no layer's
whole weights outlive it), ``_embed`` the token table and ``_head`` what
``lm_logits`` reads. ``use_spec`` is the one rule for which stored
entries are gathered. The gathers' backward reduce-scatters each
gradient into its block, and ``reduce_grads`` sums it over the axes its
block is replicated on.
"""
from __future__ import annotations

import itertools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import dist
from ..device import resolve_device
from ..tree import tree_map
from . import layers, mamba as mamba_lib, mla as mla_lib, moe as moe_lib
from . import rwkv as rwkv_lib
from .config import ModelConfig
from .decode import dist_decode
from .sharding import (ShardCtx, block_index, entry_axes, gather,
                       map_specs, shard_tree, spec_axes)

FAMILIES = ("gqa", "mla", "rwkv6", "hymba")


def _family(cfg: ModelConfig) -> str:
    if cfg.attn_type not in FAMILIES:
        raise ValueError(cfg.attn_type)
    return cfg.attn_type


def _index(tree, l: int):
    """Layer ``l`` of a stacked tree (views into the stacked tensors)."""
    if isinstance(tree, dict):
        return {k: _index(v, l) for k, v in tree.items()}
    return tree[l]


def _layer(params: dict, l: int) -> dict:
    """Layer ``l``'s parameters (views into the stacked tensors)."""
    return _index(params["layers"], l)


# --------------------------------------------------------------------------- #
# parameter init
# --------------------------------------------------------------------------- #

def _dense(gen: torch.Generator, shape, dtype, device, scale=0.02,
           index=None):
    """N(0, scale^2) drawn in float32 and cast, one matrix (the last two
    axes) at a time for stacked weights: a layer's float32 draw at a
    time, or an expert's for ``[L, E, ...]``. On the ``meta`` device, the
    shape alone. ``index`` (one slice a dimension,
    ``sharding.block_index``): only that block is kept, from the same
    draws; ``index=False``: the draws are made and dropped (None)."""
    lead = tuple(shape[:-2]) if len(shape) >= 3 else ()
    keep = index is not False
    if index is None or index is False:
        index = tuple(slice(0, n) for n in shape)
    out = torch.empty([i.stop - i.start for i in index], dtype=dtype,
                      device=device) if keep else None
    if torch.device(device).type == "meta":
        return out
    m = len(lead)
    for pos in itertools.product(*map(range, lead)):
        mat = torch.randn(shape[m:], generator=gen, device=device,
                          dtype=torch.float32) * scale
        if keep and all(i.start <= p < i.stop for p, i in zip(pos, index)):
            out[tuple(p - i.start for p, i in zip(pos, index))] = \
                mat[index[m:]]
    return out


def _init_attn(cfg: ModelConfig, ones, dense) -> dict:
    d, hd, L = cfg.d_model, cfg.head_dim_, cfg.n_layers
    return {"norm": ones(L, d),
            "wq": dense(L, d, cfg.n_heads * hd),
            "wk": dense(L, d, cfg.n_kv_heads * hd),
            "wv": dense(L, d, cfg.n_kv_heads * hd),
            "wo": dense(L, cfg.n_heads * hd, d)}


def _init_mla(cfg: ModelConfig, ones, dense) -> dict:
    m = cfg.mla
    d, h, L = cfg.d_model, cfg.n_heads, cfg.n_layers
    qk = m.nope_head_dim + m.rope_head_dim
    return {"norm": ones(L, d),
            "wq_a": dense(L, d, m.q_lora_rank),
            "q_norm": ones(L, m.q_lora_rank),
            "wq_b": dense(L, m.q_lora_rank, h * qk),
            "wkv_a": dense(L, d, m.kv_lora_rank + m.rope_head_dim),
            "kv_norm": ones(L, m.kv_lora_rank),
            "wk_b": dense(L, m.kv_lora_rank, h * m.nope_head_dim),
            "wv_b": dense(L, m.kv_lora_rank, h * m.v_head_dim),
            "wo": dense(L, h * m.v_head_dim, d)}


def _init_rwkv(cfg: ModelConfig, ones, dense, full, device) -> dict:
    d, h, L = cfg.d_model, cfg.n_heads, cfg.n_layers
    base = torch.linspace(-6.0, -1.0, d, dtype=torch.float32, device=device)
    p = {"norm": ones(L, d)}
    p.update({f"mu_{n}": full(0.5, L, d) for n in "rkvwg"})
    p.update({f"w_{n}": dense(L, d, d) for n in "rkvgo"})
    p.update({"decay_a": dense(L, d, 64), "decay_b": dense(L, 64, d),
              "decay_base": base.repeat(L, 1),
              "u": dense(L, h, d // h, scale=0.1),
              "gn_w": ones(L, d)})
    return p


def _init_hymba(cfg: ModelConfig, ones, dense, device) -> dict:
    d, L = cfg.d_model, cfg.n_layers
    di = cfg.n_heads * cfg.head_dim_
    n = cfg.ssm.d_state
    r = mamba_lib._dt_rank(cfg)
    att = _init_attn(cfg, ones, dense)
    del att["wo"]
    f32 = dict(dtype=torch.float32, device=device)
    a = torch.log(torch.arange(1, n + 1, **f32))
    mamba = {"in_proj": dense(L, d, 2 * di),
             "conv_w": dense(L, di, cfg.ssm.d_conv, scale=0.2),
             "x_proj": dense(L, di, r + 2 * n),
             "dt_proj": dense(L, r, di),
             "dt_bias": torch.full((L, di), -4.6, **f32),  # softplus^-1(0.01)
             "a_log": a.expand(L, di, n).contiguous(),
             "d_skip": torch.ones((L, di), **f32)}
    return {**att, "mamba": mamba, "attn_out_norm": ones(L, di),
            "ssm_out_norm": ones(L, di), "wo": dense(L, di, d)}


def _init_mlp(cfg: ModelConfig, ones, dense, full) -> dict:
    d, L = cfg.d_model, cfg.n_layers
    if cfg.attn_type == "rwkv6":        # RWKV's channel mix
        return {"norm": ones(L, d), "mu_k": full(0.5, L, d),
                "mu_r": full(0.5, L, d), "w_k": dense(L, d, cfg.d_ff),
                "w_v": dense(L, cfg.d_ff, d), "w_r": dense(L, d, d)}
    if cfg.moe:
        e = cfg.moe
        p = {"norm": ones(L, d), "router": dense(L, d, e.n_experts),
             "w_in": dense(L, e.n_experts, d, e.d_ff_expert),
             "w_gate": dense(L, e.n_experts, d, e.d_ff_expert),
             "w_out": dense(L, e.n_experts, e.d_ff_expert, d)}
        if e.n_shared:
            p["shared"] = {"w_in": dense(L, d, e.d_ff_shared),
                           "w_gate": dense(L, d, e.d_ff_shared),
                           "w_out": dense(L, e.d_ff_shared, d)}
        return p
    return {"norm": ones(L, d), "w_in": dense(L, d, cfg.d_ff),
            "w_gate": dense(L, d, cfg.d_ff), "w_out": dense(L, cfg.d_ff, d)}


def _build(cfg: ModelConfig, device, dense) -> dict:
    """The parameter tree, each random weight from ``dense(*shape,
    scale=)`` in the reference's order."""
    family = _family(cfg)
    dt = cfg.pdtype
    d = cfg.d_model
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    full = lambda value, *shape: torch.full(shape, value, dtype=dt,
                                            device=device)
    embed = {"tokens": dense(cfg.vocab, d)}
    if cfg.frontend == "frames":
        embed["frames"] = dense(cfg.frame_dim, d)
    attn = {"gqa": lambda: _init_attn(cfg, ones, dense),
            "mla": lambda: _init_mla(cfg, ones, dense),
            "rwkv6": lambda: _init_rwkv(cfg, ones, dense, full, device),
            "hymba": lambda: _init_hymba(cfg, ones, dense, device)}[family]
    params = {"embed": embed,
              "layers": {"attn": attn(),
                         "mlp": _init_mlp(cfg, ones, dense, full)},
              "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, cfg.vocab)
    return params


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None, specs=None, sh: ShardCtx | None = None
                ) -> dict:
    """Random parameters in the reference's tree layout, shapes and
    dtypes (RWKV's ``decay_base`` and Mamba's ``dt_bias``, ``a_log`` and
    ``d_skip`` stay float32), drawn from ``gen`` (a ``torch.Generator`` on
    ``device``). ``device``: ``cuda`` unless the caller asks for the
    CPU.

    With ``specs`` (a tree of specs, ``launch.shardings.param_specs``)
    and ``sh`` on a mesh: this rank's block of every leaf under
    ``specs``, the same values. A random weight is drawn a matrix at a
    time and only the rank's block of it kept, so that a rank holds its
    blocks and one matrix, never the whole model."""
    device = resolve_device(device)
    dt = cfg.pdtype
    if specs is None:
        return _build(cfg, device, lambda *shape, scale=0.02: _dense(
            gen, shape, dt, device, scale))
    # which leaf each draw becomes: the order of the draws, from a pass
    # on the meta device (a draw that no leaf keeps, as Hymba's
    # attention ``wo``, is made and dropped)
    made = []
    meta = _build(cfg, "meta", lambda *shape, scale=0.02: made.append(
        torch.empty(shape, dtype=dt, device="meta")) or made[-1])
    spec_of = {}
    map_specs(lambda t, spec: spec_of.__setitem__(id(t), spec), meta, specs)
    drawn = iter(made)
    blocks = []

    def dense(*shape, scale=0.02):
        spec = spec_of.get(id(next(drawn)))
        blocks.append(_dense(gen, shape, dt, device, scale, False
                             if spec is None else
                             block_index(shape, spec, sh)))
        return blocks[-1]
    tree = _build(cfg, device, dense)
    return map_specs(lambda t, spec: t if any(t is b for b in blocks)
                     else shard_tree(t, spec, sh), tree, specs)


# --------------------------------------------------------------------------- #
# per-layer windows (local/global interleave)
# --------------------------------------------------------------------------- #

def layer_windows(cfg: ModelConfig) -> Optional[list]:
    """None -> all layers global. Otherwise one entry a layer: the local
    window, or None for a global layer (the reference's ``NO_WINDOW``)."""
    if cfg.window is None:
        return None
    if cfg.attn_type == "hymba":
        glb = [l in cfg.hymba_global_layers for l in range(cfg.n_layers)]
    else:
        glb = [l % cfg.global_every == cfg.global_every - 1
               for l in range(cfg.n_layers)]
    return [None if g else int(cfg.window) for g in glb]


def _windows(cfg: ModelConfig) -> list:
    return layer_windows(cfg) or [None] * cfg.n_layers


# --------------------------------------------------------------------------- #
# full-sequence forward (prefill)
# --------------------------------------------------------------------------- #

def _seq_block(cfg: ModelConfig, sh: ShardCtx, positions, p, x, window):
    """One layer over the full sequence. Returns (x, cache_entry, aux)."""
    family = _family(cfg)
    p = _whole(cfg, sh, p, ("layers",), layer=True)
    h = layers.rms_norm(x, p["attn"]["norm"], cfg.norm_eps)
    if family == "gqa":
        a, cache = layers.gqa_attention(cfg, p["attn"], h, sh, positions,
                                        window)
    elif family == "mla":
        a, cache = mla_lib.mla_attention(cfg, p["attn"], h, sh, positions,
                                         window)
    elif family == "hymba":
        a, cache = mamba_lib.hymba_block(cfg, p["attn"], h, sh, positions,
                                         window)
    else:
        prev = x.new_zeros((x.shape[0], x.shape[2]))
        a, prev_att, state = rwkv_lib.rwkv_time_mix(cfg, p["attn"], h, sh,
                                                    prev)
        cache = {"state": state, "prev_att": prev_att}
    x = x + a
    h2 = layers.rms_norm(x, p["mlp"]["norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if family == "rwkv6":
        prev = x.new_zeros((x.shape[0], x.shape[2]))
        m, cache["prev_ffn"] = rwkv_lib.rwkv_channel_mix(cfg, p["mlp"], h2,
                                                         sh, prev)
    elif cfg.moe:
        m, aux = moe_lib.moe_block(cfg, p["mlp"], h2, sh)
    else:
        m = layers.swiglu(h2, p["mlp"], sh, cfg.adtype)
    return x + m, cache, aux


def _train_block(cfg: ModelConfig, sh: ShardCtx, positions, p, x, window):
    """``_seq_block`` without its cache: the unit ``forward_seq``
    recomputes in the backward."""
    x, _, aux = _seq_block(cfg, sh, positions, p, x, window)
    return x, aux


def _embed(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
           sh: ShardCtx, frames_ndim: int) -> torch.Tensor:
    embed = _whole(cfg, sh, params["embed"], ("embed",))
    if cfg.frontend == "frames" and inputs.ndim == frames_ndim:
        return layers.embed_frames(cfg, embed, inputs, sh)
    return layers.embed_tokens(cfg, embed, inputs, sh)


def _head(cfg: ModelConfig, params: dict, sh: ShardCtx) -> dict:
    """What ``layers.lm_logits`` reads, whole: the final norm and the head
    (a tied head, the token table)."""
    if sh.stored is None:
        return params
    head = {"final_norm": _whole(cfg, sh, params["final_norm"],
                                 ("final_norm",))}
    if cfg.tie_embeddings:
        head["embed"] = {"tokens": _whole(cfg, sh, params["embed"]["tokens"],
                                          ("embed", "tokens"))}
    else:
        head["lm_head"] = _whole(cfg, sh, params["lm_head"], ("lm_head",))
    return head


@layers.fp32_accumulation
def forward_seq(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
                sh: ShardCtx, *, collect_cache: bool):
    """inputs: int tokens [B,S] or frames [B,S,frame_dim].
    Returns (x_final [B,S,D], cache | None, aux_mean): the cache is each
    layer's entry stacked over layers (gqa ``{"k", "v"}`` of ``[L, B,
    Hkv, S, Dh]``; mla ``{"c_kv", "k_rope"}``; rwkv6 ``{"state",
    "prev_att", "prev_ffn"}``; hymba ``{"k", "v", "conv", "ssm"}``); aux
    is the mean over layers of the MoE load-balance loss (0 without
    MoE)."""
    x = _embed(cfg, params, inputs, sh, frames_ndim=3)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.float32, device=x.device)
    recompute = torch.is_grad_enabled() and not collect_cache
    caches, auxes = [], []
    for l, window in enumerate(_windows(cfg)):
        p = _layer(params, l)
        if recompute:
            x, aux = checkpoint(_train_block, cfg, sh, positions, p, x,
                                window, use_reentrant=False)
            c = None
        else:
            x, c, aux = _seq_block(cfg, sh, positions, p, x, window)
        auxes.append(aux)
        if collect_cache:
            caches.append(c)
    cache = ({k: torch.stack([c[k] for c in caches]) for k in caches[0]}
             if collect_cache else None)
    return x, cache, torch.stack(auxes).mean()


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, sh: ShardCtx
            ) -> tuple[torch.Tensor, dict]:
    """Next-token CE (+ 0.01 x the MoE's aux loss). batch: {"inputs",
    "labels"}. Returns (loss, {"ce", "aux"}), float32 scalars."""
    x, _, aux = forward_seq(cfg, params, batch["inputs"], sh,
                            collect_cache=False)
    logits = layers.lm_logits(cfg, _head(cfg, params, sh), x, sh)
    ce = dist.mean_over(layers.cross_entropy(logits, batch["labels"]), sh,
                        sh.names)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _expert_leaf(cfg: ModelConfig, path: tuple) -> bool:
    return bool(cfg.moe) and path[:2] == ("layers", "mlp") and \
        path[2:] in (("w_in",), ("w_gate",), ("w_out",))


def _map_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def use_spec(cfg: ModelConfig, sh: ShardCtx, path: tuple, spec) -> tuple:
    """The one rule for a stored parameter (at ``path``, held as ``spec``
    says): which of its spec's entries the model gathers before use. Every
    entry is gathered, except the ``"model"`` entry of an expert weight
    under the expert-parallel MoE (``moe.expert_parallel``): each rank
    computes with its own experts, which is how it holds them. Returns the
    spec to gather by."""
    if _expert_leaf(cfg, path) and moe_lib.expert_parallel(cfg, sh):
        return tuple(None if e == "model" else e for e in spec)
    return spec


def _whole(cfg: ModelConfig, sh: ShardCtx, tree, prefix: tuple,
           layer: bool = False):
    """``tree`` (the parameters under ``prefix``; ``layer``: one layer's
    views, whose stored specs lead with the layer axis) gathered as
    ``use_spec`` says; as it is without stored specs."""
    if sh.stored is None:
        return tree

    def one(path, t):
        path = prefix + path
        spec = sh.spec(path)[1:] if layer else sh.spec(path)
        return gather(t, use_spec(cfg, sh, path, spec), sh)
    return _map_paths(one, tree) if isinstance(tree, dict) else one((), tree)


def compute_specs(cfg: ModelConfig, sh: ShardCtx, tree) -> dict:
    """The specs of the parameters as the model computes with them: whole
    (``()``), but the expert weights under the expert-parallel MoE, split
    over ``"model"`` on their expert axis."""
    ep = moe_lib.expert_parallel(cfg, sh)
    return _map_paths(lambda path, t: (None, "model")
                      if ep and _expert_leaf(cfg, path) else (), tree)


def stored_specs(cfg: ModelConfig, sh: ShardCtx, tree) -> dict:
    """How ``sh`` says the parameters (of ``tree``'s structure) are held:
    its stored specs, else ``compute_specs``."""
    return sh.stored if sh.stored is not None else \
        compute_specs(cfg, sh, tree)


def shard_params(cfg: ModelConfig, params: dict, sh: ShardCtx) -> dict:
    """This rank's parameters on ``sh``'s mesh as the model computes with
    them (``compute_specs``, sliced by ``sharding.shard_tree``): where the
    model axis divides the experts (``moe.expert_parallel``), each expert
    weight ``[L, E, ...]`` keeps the rank's ``E / tp`` experts (copied, so
    the full weight can be freed); every other leaf is ``params``' own."""
    return shard_tree(params, compute_specs(cfg, sh, params), sh)


@torch.no_grad()
def reduce_grads(cfg: ModelConfig, grads: dict, sh: ShardCtx,
                 target=None) -> dict:
    """Each rank's gradients (of its ``loss_fn``, the global loss, on its
    own rows; each in the block the rank holds, ``stored_specs``) -> the
    global loss's gradients. Every rank seeds the same global loss, so the
    ranks' shares add up to the world size times the gradient, whichever
    rows each rank held. The stored gathers' backward has already summed
    a block's gradient over the axes its spec splits; here it is summed
    over every other axis of the mesh (those its block is replicated on)
    and divided by the number of ranks, in its own dtype (the reference
    reduces each micro-batch's gradients before it accumulates them in
    float32). ``target`` (specs that add an axis to a stored spec:
    ZeRO-2's, ``zero1_specs``) sums over that axis by a reduce-scatter
    along the dimension it names instead, leaving the rank its block of
    the target layout."""
    if sh.mesh is None:
        return grads
    stored = stored_specs(cfg, sh, grads)
    target = stored if target is None else target

    def reduce(g, spec, out_spec):
        held = spec_axes(spec)
        for a in sh.names:
            if a in held or sh.size(a) == 1:
                continue
            dims = [d for d, e in enumerate(out_spec) if a in entry_axes(e)]
            g = (dist.reduce_scatter(g, dims[0], sh, a) if dims
                 else dist.all_reduce(g, sh, a))
        return g / sh.world
    return tree_map(reduce, grads, stored, target)


def _pad_seq(c: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """``c`` zero-padded along ``axis`` to ``size``."""
    shape = list(c.shape)
    shape[axis] = size
    out = c.new_zeros(shape)
    out.narrow(axis, 0, c.shape[axis]).copy_(c)
    return out


def _hymba_rings(cfg: ModelConfig, cache: dict, smax: int) -> tuple:
    """The stacked prefill cache -> per-layer dicts whose k/v are ring
    buffers (slot = position % size): a prompt longer than a layer's ring
    keeps its last ``size`` rows, restacked to their slots."""
    s = cache["k"].shape[3]
    out = []
    for l, size in enumerate(hymba_cache_sizes(cfg, smax)):
        ring = {}
        for name in ("k", "v"):
            c = cache[name][l]                            # [B,Hkv,S,Dh]
            if size >= s:
                ring[name] = _pad_seq(c, 2, size)
            else:
                ps = torch.arange(s - size, s, device=c.device)
                r = c.new_zeros((*c.shape[:2], size, c.shape[3]))
                r[:, :, ps % size] = c[:, :, ps]
                ring[name] = r
        out.append({**ring, "conv": cache["conv"][l],
                    "ssm": cache["ssm"][l]})
    return tuple(out)


def _state_split(cfg: ModelConfig, sh: ShardCtx, name: str):
    """The dimension of one layer's recurrent-state cache leaf ``name``
    that a rank holds a block of on ``sh``'s mesh, over ``"model"``, as
    ``launch.shardings.cache_specs`` places it: RWKV's ``state`` [B, H,
    Dk, Dv] by its heads, Hymba's ``conv`` [B, K-1, di] and ``ssm`` [B,
    di, N] by di, where the model axis divides them; None where the rank
    holds the leaf whole."""
    if sh.mesh is None:
        return None
    family = _family(cfg)
    if family == "rwkv6" and name == "state" and sh.divides(cfg.n_heads):
        return 1
    if family == "hymba" and sh.divides(cfg.n_heads * cfg.head_dim_):
        return {"conv": 2, "ssm": 1}.get(name)
    return None


def _own_block(cfg: ModelConfig, sh: ShardCtx, name: str, x: torch.Tensor,
               lead: int = 0) -> torch.Tensor:
    """This rank's block of a whole recurrent state ``x`` (with ``lead``
    leading axes before a layer's, e.g. the layer axis), as a tensor of
    its own; ``x`` itself where the rank holds it whole."""
    d = _state_split(cfg, sh, name)
    if d is None:
        return x
    n = x.shape[d + lead] // sh.size("model")
    return x.narrow(d + lead, sh.coord("model") * n, n).clone()


def _whole_state(cfg: ModelConfig, sh: ShardCtx, c: dict, name: str
                 ) -> torch.Tensor:
    """One layer's recurrent state ``c[name]``, whole (all-gathered over
    ``"model"`` where the rank holds a block)."""
    d = _state_split(cfg, sh, name)
    return c[name] if d is None else dist.all_gather(c[name], d, sh)


def _keep_state(cfg: ModelConfig, sh: ShardCtx, c: dict, name: str,
                x: torch.Tensor) -> None:
    """Write a layer's new whole state ``x`` into ``c[name]``, in place:
    the rank's block of it where it holds a block."""
    d = _state_split(cfg, sh, name)
    if d is not None:
        n = c[name].shape[d]
        x = x.narrow(d, sh.coord("model") * n, n)
    if x is not c[name]:
        c[name].copy_(x)


def _own_rows(sh: ShardCtx, c: torch.Tensor, axis: int) -> torch.Tensor:
    """This rank's slice of a cache's sequence axis (all of it unless the
    model axis splits it), as a tensor of its own."""
    n = sh.seq_shards
    if n == 1:
        return c
    if c.shape[axis] % n:
        raise ValueError(f"a cache of {c.shape[axis]} rows does not split "
                         f"{n} ways")
    rows = c.shape[axis] // n
    return c.narrow(axis, sh.coord("model") * rows, rows).clone()


@layers.fp32_accumulation
def prefill(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
            sh: ShardCtx, smax: int):
    """Build a decode cache of capacity ``smax`` from a full prompt.
    Returns (last_logits [B,V], cache, pos int32 [B])."""
    family = _family(cfg)
    x, cache, _ = forward_seq(cfg, params, inputs, sh, collect_cache=True)
    b, s = x.shape[:2]
    if family in ("gqa", "mla") and s > smax:
        raise ValueError(f"prompt of {s} tokens past the cache's {smax}")
    if family == "gqa":
        cache = {n: _own_rows(sh, _pad_seq(c, 3, smax), 3)
                 for n, c in cache.items()}
    elif family == "mla":
        cache = {n: _own_rows(sh, _pad_seq(c, 2, smax), 2)
                 for n, c in cache.items()}
    elif family == "hymba":
        cache = tuple({n: _own_rows(sh, c, 2) if n in ("k", "v") else
                       _own_block(cfg, sh, n, c)
                       for n, c in ring.items()}
                      for ring in _hymba_rings(cfg, cache, smax))
    else:                                   # rwkv6: stacked over layers
        cache = {n: _own_block(cfg, sh, n, c, lead=1)
                 for n, c in cache.items()}
    logits = layers.lm_logits(cfg, _head(cfg, params, sh), x[:, -1:],
                              sh)[:, 0]
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, cache, pos


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #

def hymba_cache_sizes(cfg: ModelConfig, smax: int) -> tuple:
    """Per-layer KV capacities: ring buffers of the sliding window for
    local layers, the full ``smax`` for the global-attention layers."""
    w = cfg.window or smax
    return tuple(smax if l in cfg.hymba_global_layers else min(w, smax)
                 for l in range(cfg.n_layers))


def init_cache(cfg: ModelConfig, batch: int, smax: int, device=None,
               sh: ShardCtx = ShardCtx()):
    """Empty decode cache (capacity smax) in the activation dtype (RWKV's
    and Mamba's recurrent states in float32): stacked over layers, except
    Hymba's, a tuple of per-layer dicts (ring buffers of different
    sizes). On a mesh, this rank's slice of every sequence axis, and its
    block of the recurrent states where ``_state_split`` splits them."""
    family = _family(cfg)
    device = resolve_device(device)
    n = sh.seq_shards
    sizes = {"hymba": hymba_cache_sizes(cfg, smax), "rwkv6": ()}.get(
        family, (smax,))
    if any(size % n for size in sizes):
        raise ValueError(f"cache capacities {sizes} do not split {n} ways")
    smax //= n
    L, b, hd = cfg.n_layers, batch, cfg.head_dim_

    def part(name, size):            # a state dimension, the rank's block
        split = _state_split(cfg, sh, name) is not None
        return size // sh.size("model") if split else size
    zeros = lambda *shape, dtype=cfg.adtype: torch.zeros(
        shape, dtype=dtype, device=device)
    if family == "gqa":
        return {"k": zeros(L, b, cfg.n_kv_heads, smax, hd),
                "v": zeros(L, b, cfg.n_kv_heads, smax, hd)}
    if family == "mla":
        m = cfg.mla
        return {"c_kv": zeros(L, b, smax, m.kv_lora_rank),
                "k_rope": zeros(L, b, smax, m.rope_head_dim)}
    if family == "rwkv6":
        h = cfg.n_heads
        dh = cfg.d_model // h
        return {"state": zeros(L, b, part("state", h), dh, dh,
                               dtype=torch.float32),
                "prev_att": zeros(L, b, cfg.d_model),
                "prev_ffn": zeros(L, b, cfg.d_model)}
    di = cfg.n_heads * hd
    return tuple({"k": zeros(b, cfg.n_kv_heads, size, hd),
                  "v": zeros(b, cfg.n_kv_heads, size, hd),
                  "conv": zeros(b, cfg.ssm.d_conv - 1, part("conv", di)),
                  "ssm": zeros(b, part("ssm", di), cfg.ssm.d_state,
                               dtype=torch.float32)}
                 for size in (s // n for s in sizes))


def _layer_cache(cache, l: int) -> dict:
    """Layer ``l``'s cache: views into the stacked tensors (Hymba: the
    layer's own dict)."""
    return cache[l] if isinstance(cache, tuple) else _index(cache, l)


def _gqa_decode(cfg: ModelConfig, sh: ShardCtx, p, h, ck, cv, pos, window,
                cos, sin, bidx):
    """GQA attention of one token. h [B,1,D] (normed); ck/cv: this layer's
    cache ``[B,Hkv,smax,Dh]``, written in place; cos/sin ``[B,1,1,Dh/2]``,
    the RoPE tables at ``pos``. Returns the attention output [B,1,D]."""
    b = h.shape[0]
    hd = cfg.head_dim_
    adtype = cfg.adtype
    k = (h @ p["wk"].to(adtype)).reshape(b, cfg.n_kv_heads, hd)
    v = (h @ p["wv"].to(adtype)).reshape(b, cfg.n_kv_heads, hd)
    k = layers.apply_rope(k[:, :, None], cos, sin)[:, :, 0]
    posl = sh.cache_slot(pos.long(), ck.shape[2])
    # the caches' position axis second: [B, smax, Hkv, Dh] views
    layers.write_row(ck.transpose(1, 2), bidx, posl, k)
    layers.write_row(cv.transpose(1, 2), bidx, posl, v)
    q = (h @ p["wq"].to(adtype)).reshape(b, cfg.n_heads, hd)
    q = layers.apply_rope(q[:, :, None], cos, sin)[:, :, 0]
    o = dist_decode(q, ck, cv, pos + 1, sh=sh, window=window)
    o = o.to(adtype).reshape(b, 1, cfg.n_heads * hd)
    return o @ p["wo"].to(adtype)


def _decode_block(cfg: ModelConfig, sh: ShardCtx, p, x, c: dict, pos,
                  window, rope, bidx):
    """One layer, one token. x [B,1,D]; c: this layer's cache (views),
    written in place; rope: gqa's (cos, sin) at ``pos``; bidx
    ``arange(B)``. Returns x."""
    family = _family(cfg)
    p = _whole(cfg, sh, p, ("layers",), layer=True)
    new_len = pos + 1
    h = layers.rms_norm(x, p["attn"]["norm"], cfg.norm_eps)
    if family == "gqa":
        a = _gqa_decode(cfg, sh, p["attn"], h, c["k"], c["v"], pos, window,
                        *rope, bidx)
    elif family == "mla":
        mla_lib.mla_write_cache(cfg, p["attn"], h, c, new_len, sh)
        a, _ = mla_lib.mla_decode(cfg, p["attn"], h, sh, c, new_len)
    elif family == "hymba":
        # The ring write: slot = pos % capacity; attention then covers
        # min(pos + 1, capacity) slots with no further window mask (the
        # ring is the window of a local layer).
        size = c["k"].shape[2] * sh.seq_shards
        mamba_lib.hymba_write_kv(cfg, p["attn"], h, c, new_len,
                                 slot=pos % size, sh=sh)
        eff_len = torch.clamp(new_len, max=size)
        states = {n: _whole_state(cfg, sh, c, n) for n in ("conv", "ssm")}
        a, _ = mamba_lib.hymba_decode(cfg, p["attn"], h, sh,
                                      {**c, **states}, new_len, eff_len)
        for n, state in states.items():
            _keep_state(cfg, sh, c, n, state)
    else:
        a, prev_att, state = rwkv_lib.rwkv_decode_step(
            cfg, p["attn"], h, sh, c["prev_att"],
            _whole_state(cfg, sh, c, "state"))
        c["prev_att"].copy_(prev_att)
        _keep_state(cfg, sh, c, "state", state)
    x = x + a
    h2 = layers.rms_norm(x, p["mlp"]["norm"], cfg.norm_eps)
    if family == "rwkv6":
        m, _ = rwkv_lib.rwkv_channel_mix(cfg, p["mlp"], h2, sh,
                                         c["prev_ffn"])
        c["prev_ffn"].copy_(h2[:, 0])
    elif cfg.moe:
        m, _ = moe_lib.moe_block(cfg, p["mlp"], h2, sh)
    else:
        m = layers.swiglu(h2, p["mlp"], sh, cfg.adtype)
    return x + m


@layers.fp32_accumulation
def decode_step(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
                cache, pos: torch.Tensor, sh: ShardCtx):
    """One new token for every sequence in the batch.

    inputs: int [B] token ids (or [B, frame_dim] frames); cache: from
    init_cache/prefill, updated in place; pos: int32 [B] tokens already
    cached. Returns (logits [B,V], cache, pos+1).
    """
    family = _family(cfg)
    x = _embed(cfg, params, inputs[:, None], sh, frames_ndim=3)
    rope = None
    if family == "gqa":
        cos, sin = layers.rope_tables(pos.float()[:, None], cfg.head_dim_,
                                      cfg.rope_theta)
        rope = (cos[:, None], sin[:, None])
    bidx = torch.arange(x.shape[0], device=x.device)
    # Hymba's local layers attend over their rings: no window mask.
    windows = ([None] * cfg.n_layers if family == "hymba"
               else _windows(cfg))
    for l, window in enumerate(windows):
        x = _decode_block(cfg, sh, _layer(params, l), x,
                          _layer_cache(cache, l), pos, window, rope, bidx)
    logits = layers.lm_logits(cfg, _head(cfg, params, sh), x, sh)[:, 0]
    return logits, cache, pos + 1
