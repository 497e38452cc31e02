"""The bytes an answer has to move through the card's memory: a lower
bound on the traffic of any kernel that computes it from the program's
data layout (the int32 request vectors the entry point takes and gives,
the packed redirection table of 8 int32 lanes a page).

Per request: the five request vectors in (page, offset, is_write, size,
valid: 20 B), read once an answer however many design points share the
trace, and five vectors out (returns, device, latency and the two fault
flags: 20 B) a point. Per chunk and point: a 32 B table row read and a
4 B HOTNESS word written for each distinct page the chunk's valid
requests touch, and a 4 B WEAR word written for each distinct page
written on the slow device. Per decay chunk (``chunk_idx %
decay_every == decay_every - 1``) and point: the whole HOTNESS lane read
and written (8 B a page) and the slow frames' WEAR lane read (4 B a slow
frame) by the min-wear scrub. Nothing read twice is counted twice, and
the DMA engine's page copies are left out, so no kernel can do the work
in fewer bytes.
"""
from __future__ import annotations

import torch

REQUEST_IN_BYTES = 20
REQUEST_OUT_BYTES = 20
ROW_BYTES = 32
WORD_BYTES = 4
SLOW = 1


def _distinct_per_chunk(page: torch.Tensor, keep: torch.Tensor,
                        chunk: int) -> torch.Tensor:
    """[..., n_chunks]: the distinct pages among the ``keep`` requests of
    each chunk (``page`` and ``keep`` [..., N], N a chunk multiple)."""
    p = torch.where(keep, page.to(torch.int64), -1)
    p = p.reshape(*p.shape[:-1], -1, chunk).sort(dim=-1).values
    first = torch.ones_like(p, dtype=torch.bool)
    first[..., 1:] = p[..., 1:] != p[..., :-1]
    return (first & (p >= 0)).sum(dim=-1)


def answer_bytes(page: torch.Tensor, is_write: torch.Tensor,
                 device_out: torch.Tensor, *, chunk: int,
                 points: list[dict]) -> int:
    """Bytes of one answer over a trace of N requests (``page``,
    ``is_write`` [N]) whose outputs put request ``i`` of point ``b`` on
    ``device_out[b, i]`` ([B, N]). ``points`` gives each point's
    ``n_pages``, ``n_slow_pages`` and ``decay_every``."""
    n = page.shape[-1]
    pad = (-n) % chunk
    valid = torch.ones(n + pad, dtype=torch.bool, device=page.device)
    valid[n:] = False
    grow = lambda x, v: torch.cat([x, x.new_full((*x.shape[:-1], pad), v)],
                                  dim=-1)
    page, is_write = grow(page, 0), grow(is_write, False)
    device_out = grow(device_out, -1)
    n_chunks = (n + pad) // chunk
    touched = int(_distinct_per_chunk(page, valid, chunk).sum())
    total = n * REQUEST_IN_BYTES
    for b, pt in enumerate(points):
        slow_w = valid & is_write & (device_out[b] == SLOW)
        wear = int(_distinct_per_chunk(page, slow_w, chunk).sum())
        decay = sum(c % pt["decay_every"] == pt["decay_every"] - 1
                    for c in range(n_chunks))
        total += (n * REQUEST_OUT_BYTES + touched * (ROW_BYTES + WORD_BYTES)
                  + wear * WORD_BYTES
                  + decay * (pt["n_pages"] * 2 * WORD_BYTES
                             + pt["n_slow_pages"] * WORD_BYTES))
    return total
