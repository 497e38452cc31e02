"""RWKV6 "Finch" (arXiv:2404.05892): attention-free linear recurrence with
data-dependent per-channel decay. Per head, with state S in R^{Dk x Dv}:

    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T ,   log w_t = logw_t < 0

Prefill uses the chunked parallel form: inside a chunk of C tokens the
cumulative log-decays turn the recurrence into masked products, and a
loop over the S / C chunks carries the state. This module holds only the
chunked scan so far, the plain version of ``kernels/csrc/rwkv_scan.cu``.
"""
from __future__ import annotations

import torch


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
