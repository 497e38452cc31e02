"""Mixture-of-Experts FFN with capacity-based top-k routing: the dense path
of the reference's ``repro.models.moe`` (the port's counterpart).

Every token picks its top-k experts by router probability (ties to the
lower expert index, as ``jax.lax.top_k``); the slots are numbered expert
by expert, slot j = 0..k-1 in turn with the counts carried between them,
and a slot past the expert's ``capacity`` is dropped (its position clamps
to ``capacity - 1`` and it scatters zeros there). The kept tokens go
through every expert's SwiGLU as one batched product over a global
``[E, capacity, D]`` buffer, and the gated outputs are summed back.
DeepSeek-V2 style shared experts run as a dense SwiGLU alongside.
Returns the output and the switch-style load-balance auxiliary loss.

``capacity = max(4, int(T * k / E * capacity_factor))`` for the T tokens
of the call, so it follows the batch: at decode, idle lanes compete for
it as live ones do, and the sequence path and the decode path can drop
different tokens.

On a mesh (``ShardCtx.from_mesh``) whose model axis divides the experts,
each rank holds only its ``E / tp`` experts' weights
(``transformer.shard_params``). A full sequence that the model axis
divides takes the expert-parallel path, the reference's ``shard_map``:
every rank routes its own tokens (its batch rows, its sequence slice)
with the capacity of its *local* token count (``c_dev``), two all-to-alls
over ``"model"`` move the token blocks to their experts' ranks and back,
and the outputs are all-gathered on the sequence axis; the load-balance
statistics are averaged over every axis first. Once capacity binds this
drops other tokens than the dense path. Anything else on a mesh (a
decode step) takes the dense path over the whole batch: the batch
gathered, the global capacity, each rank's experts on its slice of the
buffer, the outputs gathered, exactly the reference's dense values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import dist
from .config import ModelConfig
from .layers import fp32_accumulation, swiglu
from .sharding import ShardCtx


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots an expert holds for a call over ``t`` tokens."""
    e = cfg.moe
    return max(4, int(t * e.top_k / e.n_experts * e.capacity_factor))


def _top_k_dispatch(probs: torch.Tensor, k: int, cap: int):
    """probs fp32 [T, E] -> (expert idx [T,k] int64, gates [T,k] fp32,
    pos [T,k] int64, keep [T,k] bool), equal to the reference's bit for
    bit. The top k by a stable descending sort: equal probabilities keep
    the lower expert index first, on every device; the gates' divisor
    sums the k values in order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    total = vals[:, 0]
    for j in range(1, k):             # in order, as XLA reduces k values
        total = total + vals[:, j]
    gates = vals / torch.clamp(total, min=1e-9)[:, None]
    e = probs.shape[1]
    counts = torch.zeros((e,), dtype=torch.int64, device=probs.device)
    pos_slots, keep_slots = [], []
    for j in range(k):
        onehot = F.one_hot(idx[:, j], e)
        pos = counts[None, :] + torch.cumsum(onehot, dim=0) - onehot
        pos_j = (pos * onehot).sum(dim=-1)
        keep_slots.append(pos_j < cap)
        pos_slots.append(torch.clamp(pos_j, max=cap - 1))
        counts = counts + onehot.sum(dim=0)
    return idx, gates, torch.stack(pos_slots, 1), torch.stack(keep_slots, 1)


def _route_scatter(cfg: ModelConfig, router_w, xt, cap: int):
    """xt [T,D] -> (buf [E,C,D], idx, gates, pos, keep, me, ce); me / ce
    are the switch loss's mean router probability and mean dispatch
    fraction per expert."""
    e = cfg.moe
    logits = xt.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    idx, gates, pos, keep = _top_k_dispatch(probs, e.top_k, cap)
    me = probs.mean(dim=0)
    ce = (F.one_hot(idx, e.n_experts).float().sum(dim=1) / e.top_k).mean(0)
    buf = torch.zeros((e.n_experts, cap, xt.shape[1]), dtype=cfg.adtype,
                      device=xt.device)
    src = torch.where(keep[..., None], xt[:, None, :], 0).to(cfg.adtype)
    # Each kept slot receives its one value and dropped slots zeros, so
    # the accumulation is exact in any order.
    buf.index_put_((idx, pos), src, accumulate=True)
    return buf, idx, gates, pos, keep, me, ce


def _aux_loss(cfg: ModelConfig, me, ce) -> torch.Tensor:
    return cfg.moe.n_experts * (me * ce).sum()


def _expert_ffn(p: dict, buf: torch.Tensor, adtype) -> torch.Tensor:
    """Every expert's SwiGLU over its slots: [E,C,D] -> [E,C,D]."""
    h = torch.bmm(buf, p["w_in"].to(adtype))
    g = torch.bmm(buf, p["w_gate"].to(adtype))
    h = F.silu(g.float()).to(adtype) * h
    return torch.bmm(h, p["w_out"].to(adtype))


def _combine(eo, idx, gates, pos, keep, adtype) -> torch.Tensor:
    out_slots = eo[idx, pos]                                # [T,k,D]
    w = gates * keep
    return torch.einsum("tkd,tk->td", out_slots.float(), w).to(adtype)


def expert_parallel(cfg: ModelConfig, sh: ShardCtx) -> bool:
    """Whether each rank of ``sh``'s mesh holds only its ``E / tp``
    experts."""
    return bool(cfg.moe) and sh.mesh is not None and \
        sh.divides(cfg.moe.n_experts)


def _local_experts(cfg: ModelConfig, p: dict, buf, sh: ShardCtx):
    """Every expert's SwiGLU over its slots: [E,C,D] -> [E,C,D]; on an
    expert-parallel mesh each rank's experts on its slice of ``buf``,
    gathered."""
    if not expert_parallel(cfg, sh):
        return _expert_ffn(p, buf, cfg.adtype)
    e_loc = cfg.moe.n_experts // sh.size("model")
    lo = sh.coord("model") * e_loc
    return dist.all_gather(_expert_ffn(p, buf[lo:lo + e_loc], cfg.adtype),
                           0, sh)


@fp32_accumulation
def _moe_dense(cfg: ModelConfig, p: dict, x: torch.Tensor, sh: ShardCtx):
    """The global-capacity path over the whole batch: on a mesh the
    ranks' rows are gathered first and this rank's rows returned."""
    rows = x.shape[0]
    if sh.mesh is not None:
        for a in ("data", "pod"):
            x = dist.all_gather(x, 0, sh, a)
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    buf, idx, gates, pos, keep, me, ce = _route_scatter(
        cfg, p["router"], xt, capacity(cfg, b * s))
    eo = _local_experts(cfg, p, buf, sh)
    out = _combine(eo, idx, gates, pos, keep, cfg.adtype).reshape(b, s, d)
    return out[sh.batch_rows(b)] if rows != b else out, \
        _aux_loss(cfg, me, ce)


def _moe_expert_parallel(cfg: ModelConfig, p: dict, x: torch.Tensor,
                         sh: ShardCtx):
    """The reference's ``_moe_shard_map``: x is this rank's rows [b, S, D]
    (replicated over the model axis); the rank routes its sequence slice
    with ``c_dev`` slots an expert; p's expert weights are its own
    ``E / tp`` experts'."""
    e = cfg.moe
    adtype = cfg.adtype
    b, s, d = x.shape
    msz = sh.size("model")
    e_loc = e.n_experts // msz
    sl = s // msz
    lo = sh.coord("model") * sl
    xt = x[:, lo:lo + sl].reshape(b * sl, d)
    c_dev = capacity(cfg, b * sl)
    buf, idx, gates, pos, keep, me, ce = _route_scatter(
        cfg, p["router"], xt, c_dev)
    # Token blocks to their experts' ranks: [E, C, D] -> [E_loc, tp*C, D],
    # the senders' blocks in rank order (a tiled all-to-all).
    buf = dist.all_to_all(buf, sh)
    buf = buf.reshape(msz, e_loc, c_dev, d).transpose(0, 1).reshape(
        e_loc, msz * c_dev, d)
    eo = _expert_ffn(p, buf, adtype)
    eo = eo.reshape(e_loc, msz, c_dev, d).transpose(0, 1).contiguous()
    eo = dist.all_to_all(eo, sh).reshape(e.n_experts, c_dev, d)
    out = _combine(eo, idx, gates, pos, keep, adtype).reshape(b, sl, d)
    axes = tuple(a for a in ("pod", "data", "model") if a in sh.names)
    aux = _aux_loss(cfg, dist.mean_over(me, sh, axes),
                    dist.mean_over(ce, sh, axes))
    return dist.all_gather(out, 1, sh), aux


@fp32_accumulation
def moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor, sh: ShardCtx
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (out [B,S,D], aux_loss fp32 scalar)."""
    if expert_parallel(cfg, sh) and x.shape[1] % sh.size("model") == 0:
        out, aux = _moe_expert_parallel(cfg, p, x, sh)
    else:
        out, aux = _moe_dense(cfg, p, x, sh)
    if cfg.moe.n_shared:
        out = out + swiglu(x, p["shared"], sh, cfg.adtype)
    return out, aux
