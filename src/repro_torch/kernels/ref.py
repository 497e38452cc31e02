"""Plain PyTorch versions of the kernels' functions (the port's
counterpart of ``repro.kernels.ref``): the HMMU table gather and the
attention oracles, and how far a model kernel may stand from them."""
from __future__ import annotations

import torch

NEG_INF = -1e30   # finite mask sentinel: exp(NEG_INF - NEG_INF) is 1, not NaN

# How far a model kernel's output may stand from its plain version's on
# the card, both in the working type: |kernel - plain| <= atol + rtol *
# |plain| at every element. float32 attention: the JAX kernel tests' 2e-5.
# bfloat16 attention: both sides round float32 results once to bfloat16,
# so they may differ by one bfloat16 step (at most 2^-7 of the value) plus
# the float32 sums' own difference (under 1e-6 measured on an H100). The
# limit scales with the value because attention that averages over
# thousands of keys gives |out| ~ 0.01, where an absolute 2e-2 would pass
# a dropped or repeated kv tile.
ATTN_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-5, 2.0 ** -7)}
# RWKV (float32 out): 1e-5 of the output's largest magnitude, since
# kp = k exp(-cum) grows by up to exp(88) inside a chunk and the products
# cancel (measured ~2e-7 of it on an H100).
RWKV_TOL = 1e-5


def kernel_error(kind: str, got: torch.Tensor,
                 want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, the largest share of the allowance) of a model
    kernel's output ``got`` against its plain version's ``want`` of the
    same type; ``kind`` is "attention" or "rwkv". A share above 1 fails."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"kernel output {tuple(got.shape)} {got.dtype} vs "
                         f"plain {tuple(want.shape)} {want.dtype}")
    dtype = want.dtype
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if kind == "rwkv":
        allowed = RWKV_TOL * want.abs().max().clamp_min(1e-30)
    else:
        atol, rtol = ATTN_TOL[dtype]
        allowed = atol + rtol * want.abs()
    return float(diff.max()), float((diff / allowed).max())


def hmmu_lookup(table: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Redirection-table row gather with indices clamped to
    ``[0, n_pages)``. table: int32[*batch, n_pages, W]; pages:
    int32[*batch, m] -> int32[*batch, m, W]."""
    n_pages = table.shape[-2]
    idx = pages.to(torch.int64).clamp(0, n_pages - 1)
    idx = idx[..., None].expand(*pages.shape, table.shape[-1])
    return torch.gather(table, -2, idx)


def fused_gather(lookup, table: torch.Tensor, pages: torch.Tensor,
                 extra: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Append ``extra`` page indices to the chunk's pages, run ONE
    ``lookup(table, pages)`` over the ``m + k`` indices, split the rows
    back into (chunk rows, extra rows)."""
    cat = torch.cat([pages, extra.to(pages.dtype)], dim=-1)
    rows = lookup(table, cat)
    n = pages.shape[-1]
    return rows[..., :n, :], rows[..., n:, :]


def hmmu_lookup_fused(table: torch.Tensor, pages: torch.Tensor,
                      page_a: torch.Tensor, page_b: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused gather (kernel A's fused entry): the chunk's rows and the
    rows of the DMA swap pair from the raw registers ``page_a`` and
    ``page_b`` (int32[*batch]; -1 when idle reads row 0, as
    ``clamp_min(0)`` then the clamp to ``[0, n_pages)`` does) ->
    (int32[*batch, m, W], int32[*batch, 2, W])."""
    return fused_gather(hmmu_lookup, table, pages,
                        torch.stack([page_a, page_b], dim=-1))


def _gqa_expand(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """[B, Hkv, S, D] -> [B, Hq, S, D] by repeating each kv head."""
    group = n_q_heads // k.shape[1]
    return k.repeat_interleave(group, dim=1) if group > 1 else k


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None) -> torch.Tensor:
    """Multi-head attention with GQA, causal and sliding-window masking.
    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D]; the q rows are the last Sq
    positions of the kv sequence. fp32 logits, output in ``q.dtype``."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    k = _gqa_expand(k, q.shape[1])
    v = _gqa_expand(v, q.shape[1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= qi - ki < window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     scale: float | None = None,
                     window: int | None = None) -> torch.Tensor:
    """Single-token attention over a padded KV cache. q: [B, Hq, D];
    caches: [B, Hkv, Smax, D]; kv_len: int32[B], the number of valid
    entries per sequence.

    A sequence with ``kv_len == 0`` softmaxes over an all-sentinel row and
    returns the mean of V, as ``repro.kernels.ref.decode_attention`` does;
    the CUDA kernel, like the JAX Pallas kernel, returns 0 there."""
    d = q.shape[-1]
    smax = k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    k = _gqa_expand(k_cache, q.shape[1]).float()
    v = _gqa_expand(v_cache, q.shape[1]).float()
    logits = torch.einsum("bhd,bhkd->bhk", q.float(), k) * scale
    ki = torch.arange(smax, device=q.device)[None, None, :]
    n = kv_len.to(q.device)[:, None, None]
    mask = ki < n
    if window is not None:
        mask &= ki >= n - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", p, v)
    return out.to(q.dtype)
