"""RWKV6 "Finch" (arXiv:2404.05892): attention-free linear recurrence with
data-dependent per-channel decay. Per head, with state S in R^{Dk x Dv}:

    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T ,   log w_t = logw_t < 0

Prefill uses the chunked parallel form: inside a chunk of C tokens the
cumulative log-decays turn the recurrence into masked products, and a
loop over the S / C chunks carries the state (``rwkv_chunk_scan``, also
the plain version of ``kernels/csrc/rwkv_scan.cu``). Decode is the O(1)
single-step update. The reference's simplifications are kept: static
token-shift lerps, and an RMS-style per-head group norm.

A chunk that does not divide the sequence becomes the whole sequence, as
in the reference. With the model's decay init (``decay_base`` from -6 to
-1) a token's log-decay reaches about -0.37, so a whole-sequence "chunk"
past ~238 tokens overflows float32 in ``exp(-cumsum)``, in both packages:
run prompts whose length is a multiple of ``cfg.rwkv_chunk``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import fp32_accumulation
from .sharding import ShardCtx


SCAN_BASE = 16


def prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 prefix sum along ``dim`` in the order of XLA's
    CPU ``cumsum``: a length up to 16 is summed in order; a longer one is
    cut into blocks of 16 (the last padded with zeros), each summed in
    order, and each block's sums get the prefix sum of the earlier
    blocks' totals (taken the same way) added once. The CUDA kernel sums
    in this order too, so the two agree bit for bit on every device
    (``torch.cumsum`` sums in a tree on CUDA and in float64 on the CPU)."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n <= SCAN_BASE:
        out = x.clone()
        for t in range(1, n):
            out[t] = out[t - 1] + x[t]
        return out.movedim(0, dim)
    m = -(-n // SCAN_BASE) * SCAN_BASE
    pad = x.new_zeros((m - n, *x.shape[1:]))
    blocks = torch.cat([x, pad]).reshape(m // SCAN_BASE, SCAN_BASE,
                                         *x.shape[1:])
    within = prefix_sum(blocks, 1)
    before = prefix_sum(within[:, -1], 0)
    before = torch.cat([torch.zeros_like(before[:1]), before[:-1]])
    out = (within + before[:, None]).reshape(m, *x.shape[1:])[:n]
    return out.movedim(0, dim)


def rwkv_chunk_scan(r, k, v, logw, u, chunk: int):
    """Chunked linear attention. r/k/logw [B,H,S,Dk], v [B,H,S,Dv],
    u [H,Dk] bonus. Returns (out fp32 [B,H,S,Dv], final state fp32
    [B,H,Dk,Dv]). A chunk that does not divide S becomes S."""
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    c = min(chunk, s)
    if s % c:
        c = s
    n = s // c

    rc = r.reshape(b, h, n, c, dk).float()
    kc = k.reshape(b, h, n, c, dk).float()
    vc = v.reshape(b, h, n, c, dv).float()
    lwc = logw.reshape(b, h, n, c, dk).float()

    lw_cum = prefix_sum(lwc, 3)                           # inclusive
    lw_tot = lw_cum[:, :, :, -1]                          # [B,H,N,Dk]
    lw_excl = lw_cum - lwc                                # exclusive

    # q'_t = r_t * A_{t-1};  k'_s = k_s / A_s  (stable in log space).
    qp = rc * torch.exp(lw_excl)
    kp = kc * torch.exp(-lw_cum)
    # inter-chunk key weight: k_s * A_T / A_s
    kt = kc * torch.exp(lw_tot[:, :, :, None] - lw_cum)

    # Intra-chunk: strictly-lower-triangular (s < t) plus diag u bonus.
    att = torch.einsum("bhntk,bhnsk->bhnts", qp, kp)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    att = torch.where(mask, att, 0.0)
    diag = torch.einsum("bhntk,hk->bhnt", rc * kc, u.float())
    intra = torch.einsum("bhnts,bhnsv->bhntv", att, vc)
    intra = intra + diag[..., None] * vc

    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    out = torch.empty((b, h, n, c, dv), dtype=torch.float32, device=r.device)
    for i in range(n):
        out[:, :, i] = intra[:, :, i] + torch.einsum(
            "bhtk,bhkv->bhtv", qp[:, :, i], state)
        state = state * torch.exp(lw_tot[:, :, i])[..., None] + \
            torch.einsum("bhsk,bhsv->bhkv", kt[:, :, i], vc[:, :, i])
    return out.reshape(b, h, s, dv), state


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x [B,S,D], prev [B,D] (the last token of the previous segment) ->
    x shifted one token right."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu          # lerp(x, shifted, mu)


def _decay(cfg: ModelConfig, p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent log-decay (the Finch contribution), float32 [B,S,D],
    negative."""
    dd = xw @ p["decay_a"].to(xw.dtype)
    dd = torch.tanh(dd.float()).to(xw.dtype) @ p["decay_b"].to(xw.dtype)
    return -torch.exp(torch.clamp(p["decay_base"].float() + dd.float(),
                                  -8.0, 6.0))


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h).transpose(1, 2)      # [B,H,S,Dh]


def _group_norm_gate(cfg: ModelConfig, p: dict, out: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """Per-head RMS group norm of the float32 scan output ``out`` [...,D],
    its weight, the SiLU gate ``g`` and the output projection."""
    adtype = cfg.adtype
    h = cfg.n_heads
    shape = out.shape
    gn = out.reshape(*shape[:-1], h, shape[-1] // h)
    gn = gn * torch.rsqrt((gn * gn).mean(dim=-1, keepdim=True)
                          + cfg.norm_eps)
    o = (gn.reshape(shape) * p["gn_w"].float()).to(adtype)
    o = o * F.silu(g.float()).to(adtype)
    return o @ p["w_o"].to(adtype)


def _projections(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 xs: torch.Tensor):
    """r, k, v, g [B,S,D] in the activation dtype and the log-decay."""
    adtype = cfg.adtype
    proj = lambda name: _mix(x, xs, p["mu_" + name].to(adtype)) @ \
        p["w_" + name].to(adtype)
    logw = _decay(cfg, p, _mix(x, xs, p["mu_w"].to(adtype)))
    return proj("r"), proj("k"), proj("v"), proj("g"), logw


@fp32_accumulation
def rwkv_time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, sh: ShardCtx,
                  prev: torch.Tensor):
    """x [B,S,D]; prev [B,D]. Returns (out [B,S,D], new_prev, new_state
    fp32 [B,H,Dk,Dv]); the state seeds the decode steps."""
    b, s, d = x.shape
    h = cfg.n_heads
    r, k, v, g, logw = _projections(cfg, p, x, _token_shift(x, prev))
    out, state = rwkv_chunk_scan(_heads(r, h), _heads(k, h), _heads(v, h),
                                 _heads(logw.to(cfg.adtype), h), p["u"],
                                 cfg.rwkv_chunk)
    out = out.transpose(1, 2).reshape(b, s, d)
    return _group_norm_gate(cfg, p, out, g), x[:, -1], state


@fp32_accumulation
def rwkv_decode_step(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     sh: ShardCtx, prev: torch.Tensor, state: torch.Tensor):
    """One token. x [B,1,D]; prev [B,D]; state fp32 [B,H,Dk,Dv]. Returns
    (out [B,1,D], new_prev [B,D], new_state)."""
    b, _, d = x.shape
    h = cfg.n_heads
    dh = d // h
    r, k, v, g, logw = _projections(cfg, p, x, prev[:, None])
    rh, kh, vh = (t[:, 0].reshape(b, h, dh).float() for t in (r, k, v))
    w = torch.exp(logw[:, 0].reshape(b, h, dh))
    kv = kh[..., :, None] * vh[..., None, :]              # [B,H,Dk,Dv]
    out = torch.einsum("bhk,bhkv->bhv", rh,
                       state + p["u"].float()[None, :, :, None] * kv)
    new_state = state * w[..., None] + kv
    o = _group_norm_gate(cfg, p, out.reshape(b, d), g[:, 0])
    return o[:, None], x[:, 0], new_state


@fp32_accumulation
def rwkv_channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     sh: ShardCtx, prev: torch.Tensor):
    """The channel-mix FFN (relu^2) with token shift. x [B,S,D], prev
    [B,D] -> (out [B,S,D], new_prev [B,D])."""
    adtype = cfg.adtype
    xs = _token_shift(x, prev)
    xk = _mix(x, xs, p["mu_k"].to(adtype))
    xr = _mix(x, xs, p["mu_r"].to(adtype))
    kk = xk @ p["w_k"].to(adtype)
    kk = torch.square(torch.relu(kk.float())).to(adtype)
    vv = kk @ p["w_v"].to(adtype)
    rr = torch.sigmoid((xr @ p["w_r"].to(adtype)).float())
    return vv * rr.to(adtype), x[:, -1]
