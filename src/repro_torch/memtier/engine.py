"""Batched serving engine with the HMMU-managed tiered KV cache (the
port's counterpart of ``repro.memtier.engine``).

Continuous-batching style: requests join a fixed-capacity batch slot-wise,
prefill fills the slot's cache region, decode advances every slot one
token per step. The model's decode path runs on the engine's device; the
memory-system behaviour of the cache streams through the
:class:`TieredKVAccounting` platform on the same device each step (on a
card, one launch of the chunk-step kernel a step).

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit CPU it raises. A step reads the new
positions and tokens back to the host once, for every lane together; an
admission reads its first token back once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import EmulatorConfig
from ..device import resolve_device
from ..models import (ModelConfig, ShardCtx, decode_step, init_cache,
                      prefill)
from .tiered_cache import TieredKVAccounting


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # int32 [S] (or frames [S, frame_dim])
    max_new_tokens: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def splice(dst, src, slot: int) -> None:
    """Copy lane 0 of a one-lane cache ``src`` into lane ``slot`` of
    ``dst``, in place. The stacked caches (``[L, B, ...]`` leaves) hold
    the lane on axis 1; Hymba's tuple of per-layer dicts (``[B, ...]``
    leaves) holds it on axis 0. (The reference splices every family on
    axis 1, which for Hymba writes the lane into the heads, conv taps or
    channels of every lane: a divergence the port does not copy.)"""
    if isinstance(dst, tuple):
        for dst_l, src_l in zip(dst, src):
            for name, t in dst_l.items():
                t[slot].copy_(src_l[name][0])
        return
    for name, t in dst.items():
        t[:, slot].copy_(src[name][:, 0])


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, batch_size: int = 4,
                 smax: int = 256, emu_cfg: EmulatorConfig | None = None,
                 policy: str = "hotness", sh: ShardCtx | None = None,
                 eos: int | None = None, pin_pages_per_seq: int = 1,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.sh = sh or ShardCtx()
        self.b = batch_size
        self.smax = smax
        self.eos = eos
        self.cache = init_cache(cfg, batch_size, smax, device=self.device)
        self.pos = torch.zeros((batch_size,), dtype=torch.int32,
                               device=self.device)
        self.tokens = torch.zeros((batch_size,), dtype=torch.int32,
                                  device=self.device)
        self.active: list[Request | None] = [None] * batch_size
        self.queue: list[Request] = []
        emu_cfg = emu_cfg or EmulatorConfig(
            n_fast_pages=256, n_slow_pages=2048, chunk=64, policy=policy)
        if emu_cfg.policy != policy:
            emu_cfg = emu_cfg.with_(policy=policy)
        kv_bytes = self._kv_bytes_per_position()
        # pin_pages_per_seq: §III-G placement contracts — each sequence's
        # first KV pages (streamed every decode step) are allocated
        # pin=True; report() exposes the pinned-page fast hit rate.
        self.tier = TieredKVAccounting(emu_cfg, cfg.n_layers,
                                       positions_per_page=64,
                                       bytes_per_position=max(64, kv_bytes),
                                       pin_pages_per_seq=pin_pages_per_seq,
                                       device=self.device)

    def _decode(self, params, tokens, cache, pos):
        return decode_step(self.cfg, params, tokens, cache, pos, self.sh)

    def _prefill(self, params, inputs):
        return prefill(self.cfg, params, inputs, self.sh, self.smax)

    def _kv_bytes_per_position(self) -> int:
        c = self.cfg
        if c.attn_type == "mla":
            return 2 * (c.mla.kv_lora_rank + c.mla.rope_head_dim)
        if c.attn_type == "rwkv6":
            return 0
        return 2 * 2 * c.n_kv_heads * c.head_dim_

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.b):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.active[slot] = req
                # slot-wise prefill: run the prompt through its own lane
                prompt = torch.as_tensor(req.prompt, device=self.device)[None]
                logits, cache1, pos1 = self._prefill(self.params, prompt)
                # splice lane 0 of the fresh cache into this slot, in place
                splice(self.cache, cache1, slot)
                self.pos[slot] = pos1[0]
                nxt = logits[0].argmax()
                self.tokens[slot] = nxt
                req.out.append(int(nxt))

    def step(self) -> bool:
        """One decode step for the whole batch. Returns False when idle."""
        self._admit()
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return False

        logits, self.cache, self.pos = self._decode(
            self.params, self.tokens, self.cache, self.pos)
        self.tokens = logits.argmax(dim=-1).to(torch.int32)
        pos, nxt = torch.stack([self.pos, self.tokens]).cpu().numpy()

        # --- memory-system accounting through the HMMU platform -------------
        kv_lens = [int(pos[i]) for i in live]
        windows = None
        if self.cfg.window is not None:
            windows = [self.cfg.window] * len(live)
        trace = self.tier.access_trace([self.active[i].rid for i in live],
                                       kv_lens, windows)
        self.tier.account(trace)

        for i in live:
            req = self.active[i]
            tok = int(nxt[i])
            req.out.append(tok)
            if len(req.out) >= req.max_new_tokens or \
                    (self.eos is not None and tok == self.eos) or \
                    int(pos[i]) >= self.smax - 1:
                req.done = True
                self.tier.free_sequence(req.rid)
                self.active[i] = None
        return True

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(self.active)) and steps < max_steps:
            if not self.step():
                break
            steps += 1
        return steps

    def report(self) -> dict:
        return self.tier.report()
